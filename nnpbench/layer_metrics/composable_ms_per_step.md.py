"""composable_ms_per_step.md: see nnpbench/readers.py, ``composable_ms_per_step``."""

from nnpbench.readers import composable_ms_per_step as read  # noqa: F401
