"""Columnar, static-shape relational tables for PyTorch.

A :class:`Table` is the device-native replacement for a row-store relation:
every column is a dense 1-D tensor of identical static length
(``capacity``), and a boolean ``valid`` mask carries the dynamic
cardinality.  All relational operators in :mod:`repro_torch.relational`
preserve this invariant, so a whole extraction plan runs on the device with
no data-dependent shapes and no host round-trips in the middle.

Conventions
-----------
* Key columns are ``int32`` (non-negative ids).  ``float32`` measure columns
  are allowed but never joined on.  Every stored column keeps its dtype:
  ``table_digest`` hashes raw bytes, so an ``int32`` column that drifts to
  ``int64`` changes the digest.
* Invalid rows may hold arbitrary garbage; operators must mask through
  ``valid`` and never rely on invalid slots being zeroed.
* Join outputs are *prefix-compacted*: valid rows occupy slots ``[0, n)``.
  Filter outputs are not; use :func:`repro_torch.relational.ops.compact` if
  a prefix layout is required.
* Tables live on one device.  Entry points that build tables take a
  ``device``; ``None`` means the CUDA card and raises when there is none
  (see :func:`resolve_device`).  Pass ``device="cpu"`` to run on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# Sentinel used for invalid / null int32 keys.  Valid ids must be < NULL_KEY.
NULL_KEY = np.int32(2**31 - 1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``None`` means the CUDA card.

    Never falls back to the CPU silently: without a card, ``None`` raises,
    and the caller must ask for ``device="cpu"`` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        return torch.device("cuda")
    return torch.device(device)


def host(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (same dtype)."""
    return t.detach().cpu().numpy()


# The 64-bit types ``jnp.asarray`` narrows with x64 off (the JAX package's
# setting); bool and the 32-bit types pass unchanged.
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32}


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def check_int32_scalar(value) -> None:
    """Raise ``OverflowError`` for a Python int outside int32, which
    ``jnp`` refuses with x64 off and torch would wrap silently."""
    if isinstance(value, int) and not INT32_MIN <= value <= INT32_MAX:
        raise OverflowError(
            f"Python int {value} is out of bounds for int32")


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    """A column from a tensor (dtype kept) or from numpy / Python values,
    canonicalised as ``jnp.asarray`` does: int64 -> int32, uint64 ->
    uint32, float64 -> float32.  Python ints that make an integer column
    and lie outside int32 raise ``OverflowError``, as in ``jnp.asarray``
    (numpy arrays wrap in both)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    # np.array copies: read-only views (e.g. of another framework's
    # buffers) cannot back a tensor
    a = np.array(v)
    if not isinstance(v, np.ndarray) and a.dtype.kind in "iu" and a.size \
            and (a.min() < INT32_MIN or a.max() > INT32_MAX):
        raise OverflowError(
            f"Python int {a.max() if a.max() > INT32_MAX else a.min()} is "
            "out of bounds for int32")
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(frozen=True)
class Table:
    """An immutable columnar relation with a validity mask.

    Attributes:
      columns: mapping column-name -> 1-D tensor, all of length ``capacity``.
      valid:   bool tensor of length ``capacity``; True where the row is live.
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor

    # -- construction -------------------------------------------------------
    @classmethod
    def from_arrays(cls, capacity: int | None = None, device=None,
                    **columns) -> "Table":
        """Build a table from equal-length arrays, padding to ``capacity``.

        ``device=None`` places the table on the CUDA card (see
        :func:`resolve_device`).
        """
        dev = resolve_device(device)
        cols = {k: _as_tensor(v, dev) for k, v in columns.items()}
        if not cols:
            raise ValueError("Table needs at least one column")
        n = len(next(iter(cols.values())))
        for k, v in cols.items():
            if v.ndim != 1 or len(v) != n:
                raise ValueError(
                    f"column {k!r} has shape {tuple(v.shape)}, want ({n},)")
        cap = n if capacity is None else capacity
        if cap < n:
            raise ValueError(f"capacity {cap} < data length {n}")
        valid = torch.arange(cap, device=dev) < n
        padded = {}
        for k, v in cols.items():
            pad = torch.zeros((cap - n,), dtype=v.dtype, device=dev)
            padded[k] = torch.cat([v, pad]) if cap > n else v
        return cls(columns=padded, valid=valid)

    # -- accessors ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def num_rows(self) -> torch.Tensor:
        """On-device count of live rows."""
        return self.valid.sum(dtype=torch.int32)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self.columns))

    # -- basic transforms (shape-preserving) ---------------------------------
    def with_columns(self, **extra) -> "Table":
        cols = dict(self.columns)
        for k, v in extra.items():
            v = torch.as_tensor(v, device=self.device)
            if tuple(v.shape) != (self.capacity,):
                raise ValueError(
                    f"column {k!r} shape {tuple(v.shape)} != "
                    f"({self.capacity},)")
            cols[k] = v
        return Table(columns=cols, valid=self.valid)

    def select(self, names) -> "Table":
        return Table(
            columns={n: self.columns[n] for n in names}, valid=self.valid
        )

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(k, k): v for k, v in self.columns.items()}
        if len(cols) != len(self.columns):
            raise ValueError(f"rename collision: {mapping}")
        return Table(columns=cols, valid=self.valid)

    def prefix(self, alias: str) -> "Table":
        """Namespace every column as ``<alias>.<col>`` (query-alias scoping)."""
        return self.rename({k: f"{alias}.{k}" for k in self.columns})

    def mask(self, keep: torch.Tensor) -> "Table":
        return Table(columns=self.columns, valid=self.valid & keep)

    # -- host-side materialization -------------------------------------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Return compacted host arrays containing only valid rows."""
        return {k: host(v[self.valid]) for k, v in self.columns.items()}

    def to_rowset(self, names=None) -> set:
        """Set of row tuples over ``names`` (default all columns), valid only.

        Multisets are represented by appending a per-duplicate rank so tests
        can compare join results exactly (bag semantics).
        """
        names = list(names) if names is not None else list(self.column_names())
        data = self.to_numpy()
        rows = list(zip(*(data[n].tolist() for n in names))) if names else []
        seen: Dict[tuple, int] = {}
        out = set()
        for r in rows:
            k = seen.get(r, 0)
            seen[r] = k + 1
            out.add(r + (k,))
        return out
