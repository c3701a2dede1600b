"""Tree analyses: payload bytes per node, FLOP/byte accounting per apply.

Counterpart of ``indigo_tpu/analyses.py``: ``Memusage`` walks a tree with
the port's ``transforms.Visitor`` and reads ``Operator.memusage`` (the bytes
of the buffers a node holds); ``apply_cost`` is ``Operator.cost``.
"""
from __future__ import annotations

from .operators import Operator
from .transforms import Visitor

__all__ = ["Memusage", "memusage_report", "apply_cost"]


class Memusage(Visitor):
    """Collect (name, shape, payload bytes) rows for every node."""

    def __init__(self):
        self.rows = []

    def generic_visit(self, node):
        own = node.memusage() - sum(c.memusage() for c in node.children())
        self.rows.append((node.name, node.shape, int(own)))
        for c in node.children():
            self.visit(c)
        return node


def memusage_report(op: Operator) -> str:
    v = Memusage()
    v.visit(op)
    total = op.memusage()
    lines = [f"{'node':<16} {'shape':<20} {'payload':>12}"]
    for name, shape, b in v.rows:
        lines.append(f"{name:<16} {str(shape):<20} {b:>12,}")
    lines.append(f"{'TOTAL':<16} {'':<20} {total:>12,}")
    return "\n".join(lines)


def apply_cost(op: Operator, ncols: int = 1):
    """(flops, bytes) estimate of one forward apply with ``ncols`` columns;
    a complex multiply-add counts as 8 flops. The per-node formulas live on
    ``Operator.cost``, so a leaf without one raises instead of counting 0."""
    return op.cost(ncols)
