"""Errors of the PyTorch package.

``ExecError`` is the counterpart of myscaledb_tpu/sql/executor.py::ExecError
(kept here so that the expression evaluator and the parser can raise
``NotPortedError`` without importing the executor).
"""

from __future__ import annotations


class ExecError(ValueError):
    pass


class NotPortedError(ExecError):
    """A statement or expression that the JAX package runs but this package
    does not run yet.  The message names the slice of the port (ROADMAP.md,
    queue 1) that brings it; each such error goes away when its slice
    lands."""

    def __init__(self, what: str, slice_name: str):
        self.what = what
        self.slice_name = slice_name
        super().__init__(
            f"{what} is not ported to myscaledb_tpu_torch yet: it comes with "
            f"the '{slice_name}' slice (ROADMAP.md, queue 1)")
