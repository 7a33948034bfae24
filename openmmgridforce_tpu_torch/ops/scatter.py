"""Row sums in a fixed order on the card.

``index_add_`` on a CUDA tensor adds with atomics, in no fixed order:
two runs of one MD step differ in the last bits, and the differences grow
along a trajectory, so a recorded segment could not be held against the
eager one. On the card a row sum here gathers each atom's rows through a
per-atom table of row positions, weights them and sums them: three
launches (gather, product, sum) in a fixed order, where the atomic
scatter takes one. The table is built on the host once per index, keyed
by the persistent tensors the index is made from (a system's or a
constraint set's), so a recorded step finds it without a
synchronisation. On the CPU a row sum is ``index_add_``, which
adds in index order, as the JAX package's scatters do.

A :class:`RowSum` says where rows go: ``index`` [K] the atom of each row,
and ``coef`` [K] a factor per row (None for ones). Its ``src`` may hold
K / m rows, which then serve m times in turn (row k reads src row
k mod K / m): the constraint solver hands the pairs' updates once and
weights them -1/m_i for the first atoms and +1/m_j for the second.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

# (ids of the key tensors, extra) -> (weakrefs of the keys, table)
_TABLES = {}


class RowSum(NamedTuple):
    index: torch.Tensor             # [K] atom of each row
    coef: Optional[torch.Tensor]    # [K] factor of each row, or None
    n_atoms: int
    src_rows: int                   # rows the src holds (K / m)
    sel: Optional[torch.Tensor]     # fixed order: [n_atoms * D] src rows
    weight: Optional[torch.Tensor]  # fixed order: [n_atoms, D, 1]


def row_table(index, n_atoms: int):
    """[n_atoms, D] positions in ``index`` of each atom's rows, in order,
    padded with ``len(index)`` (D the most rows an atom has, at least 1);
    built on the host."""
    ids = index.cpu().numpy()
    counts = np.bincount(ids, minlength=n_atoms)
    table = np.full((n_atoms, max(int(counts.max(initial=0)), 1)), len(ids),
                    dtype=np.int64)
    order = np.argsort(ids, kind="stable")
    start = 0
    for atom, c in enumerate(counts):
        table[atom, :c] = order[start:start + c]
        start += c
    return table


def cached(keys, extra, build):
    """``build()``, cached by the identity of the tensors ``keys`` and by
    ``extra``, so that a recording finds a table built on the host without
    a synchronisation; entries whose keys are gone are dropped."""
    key = (tuple(id(k) for k in keys), extra)
    hit = _TABLES.get(key)
    if hit is not None and all(r() is k for r, k in zip(hit[0], keys)):
        return hit[1]
    for dead in [k for k, (refs, _) in _TABLES.items()
                 if any(r() is None for r in refs)]:
        del _TABLES[dead]
    value = build()
    _TABLES[key] = (tuple(weakref.ref(k) for k in keys), value)
    return value


def _tables(index, n_atoms, src_rows, keys):
    """sel [n_atoms * D], table [n_atoms, D] and the padding mask
    [n_atoms, D, 1] of ``index``, and the mask by dtype once asked for."""
    def build():
        table = row_table(index, n_atoms)
        pad = table == len(index)
        dev = index.device
        return {"sel": torch.as_tensor(np.where(pad, 0, table % src_rows)
                                       .reshape(-1), device=dev),
                "table": torch.as_tensor(table, device=dev),
                "mask": torch.as_tensor(~pad[..., None], device=dev)}

    return cached(keys, ("rows", n_atoms, len(index), src_rows), build)


def fixed_order_plan(index, n_atoms: int, keys, coef=None,
                     src_rows: int = None, dtype=None) -> RowSum:
    """The card's plan on any device: the gather table of ``index``
    (padding reads row 0 with weight 0), cached by the identity of the
    tensors ``keys``, and the slots' weights (``coef``'s, or ones in
    ``dtype``)."""
    src_rows = len(index) if src_rows is None else int(src_rows)
    t = _tables(index, n_atoms, src_rows, keys)
    if coef is None:
        dtype = torch.get_default_dtype() if dtype is None else dtype
        weight = t.get(dtype)
        if weight is None:
            weight = t[dtype] = t["mask"].to(dtype)
    else:
        # padding points one past coef: a zero weight
        weight = torch.cat([coef, coef.new_zeros(1)])[t["table"]][..., None]
    return RowSum(index, coef, n_atoms, src_rows, t["sel"], weight)


def row_sum_plan(index, n_atoms: int, keys, coef=None,
                 src_rows: int = None, dtype=None) -> RowSum:
    """The row sum of ``index`` [K] onto ``n_atoms`` atoms, each row times
    ``coef`` [K] (None: ones, for a src of ``dtype``), from a src of
    ``src_rows`` rows (default K). ``keys``: the persistent tensors
    ``index`` is made from, which key its table on the card. On the CPU
    the plan is ``index_add_``'s."""
    if not index.is_cuda:
        src_rows = len(index) if src_rows is None else int(src_rows)
        return RowSum(index, coef, n_atoms, src_rows, None, None)
    return fixed_order_plan(index, n_atoms, keys, coef, src_rows, dtype)


def _rows(plan, src):
    """src's rows as the plan's K rows, times coef (index_add_'s operand)."""
    m = len(plan.index) // plan.src_rows
    rows = src if m == 1 else torch.cat([src] * m, dim=-2)
    return rows if plan.coef is None else rows * plan.coef[:, None]


def row_sum(plan: RowSum, src):
    """[..., n_atoms, 3]: each atom's rows of ``src`` [..., K / m, 3],
    weighted and summed; in a fixed order on the card."""
    if plan.sel is None:
        out = src.new_zeros(src.shape[:-2] + (plan.n_atoms,)
                            + src.shape[-1:])
        return out.index_add_(-2, plan.index, _rows(plan, src))
    rows = src.index_select(-2, plan.sel).unflatten(
        -2, tuple(plan.weight.shape[:2]))
    return (rows * plan.weight).sum(-2)


def add_rows(out, plan: RowSum, src):
    """``out`` [..., n_atoms, 3] += ``row_sum(plan, src)``, in place."""
    if plan.sel is None:
        return out.index_add_(-2, plan.index, _rows(plan, src))
    return out.add_(row_sum(plan, src))
