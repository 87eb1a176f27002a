"""mfu.md: see nnpbench/readers.py, ``step_mfu``."""

from nnpbench.readers import step_mfu as read  # noqa: F401
