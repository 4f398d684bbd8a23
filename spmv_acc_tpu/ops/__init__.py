"""Kernel-strategy zoo (the analog of the reference's src/acc/hip*/ directories).

XLA strategies live in :mod:`.xla`, :mod:`.flat` and :mod:`.zoo`; the Pallas
(Triton) kernel in :mod:`.vector_row`; dense-block paths in :mod:`.bsr`; higher-level ops in
:mod:`.spmm`, :mod:`.spgemm`, :mod:`.trisolve`; the CPU golden in :mod:`.golden`.
"""

from . import golden, xla

__all__ = ["golden", "xla"]
