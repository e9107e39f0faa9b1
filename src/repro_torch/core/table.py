"""HPTMT Table abstraction (PyTorch port of ``repro/core/table.py``).

A :class:`Table` is a struct-of-columns: every column is a fixed-
``capacity`` 1-D tensor and ``nvalid`` (a 0-d int32 tensor on the same
device) says how many leading rows are live.

Representation invariants
-------------------------
* every column has shape ``(capacity,)`` and the same capacity;
* valid rows are compacted to the front: rows ``[0, nvalid)`` are live,
  rows ``[nvalid, capacity)`` are padding (arbitrary values);
* nulls inside live rows are encoded with sentinels (``INT_NULL``, NaN).

Column dtype contract
---------------------
The engine stores two column dtypes: **int32** for integer/bool columns
and **float32** for float columns.  Ingestion narrows wider inputs through
:func:`narrow_column`: ``float64 -> float32`` silently; integer values
must fit int32 and raise otherwise (two int64 keys 2^32 apart would alias
to the same int32 bits and fabricate join matches).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .kernel_backend import resolve_device

INT_NULL = np.iinfo(np.int32).min
FLOAT_NULL = np.nan


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """A float column with every subnormal (and ``-0.0``) replaced by
    ``+0.0``; other dtypes unchanged.

    The reference compares subnormal float32 values as zero (XLA flushes
    them on the CPU and the TPU), so wherever the port derives a
    comparison key, sort word, hash or partition bits from a float
    column it flushes them first; emitted values keep their own bits.
    Explicit tensor code, not a float mode: CUDA compares IEEE values."""
    if not x.dtype.is_floating_point:
        return x
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny,
                       torch.zeros_like(x), x)


def flush_subnormals_np(x: np.ndarray) -> np.ndarray:
    """numpy copy of :func:`flush_subnormals`, for the host planners."""
    if not np.issubdtype(x.dtype, np.floating):
        return x
    return np.where(np.abs(x) < np.finfo(x.dtype).tiny,
                    np.zeros((), x.dtype), x)


def narrow_column(name: str, v: np.ndarray) -> np.ndarray:
    """Narrow an ingested numpy column to the engine dtype contract.

    Floats narrow silently; integer/bool values outside the int32 range
    raise ``ValueError`` instead of truncating."""
    if np.issubdtype(v.dtype, np.floating):
        return v.astype(np.float32)
    if np.issubdtype(v.dtype, np.integer) or v.dtype == np.bool_:
        if v.dtype != np.int32 and v.size:
            info = np.iinfo(np.int32)
            lo, hi = v.min(), v.max()
            if lo < info.min or hi > info.max:
                raise ValueError(
                    f"column {name!r} ({v.dtype}) has values in "
                    f"[{lo}, {hi}] outside the int32 range "
                    f"[{info.min}, {info.max}]; refusing to truncate "
                    "(aliased keys make false join matches) — "
                    "dictionary-encode wide keys first "
                    "(repro_torch.data.dictionary)")
        return v.astype(np.int32)
    raise TypeError(
        f"column {name!r} dtype {v.dtype} unsupported; dictionary-"
        "encode strings first (repro_torch.data.dictionary)")


def _is_float(x: torch.Tensor) -> bool:
    return x.dtype.is_floating_point


@dataclasses.dataclass
class Table:
    """Columnar table with static capacity and a device-side row count."""

    columns: dict[str, torch.Tensor]      # name -> (capacity,) tensor
    nvalid: torch.Tensor                  # 0-d int32 tensor

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return self.nvalid.device

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns.keys())

    @property
    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.nvalid

    @classmethod
    def from_dict(cls, data: Mapping[str, Any], capacity: int | None = None,
                  device=None) -> "Table":
        """Build a table from numpy columns, padding to ``capacity``."""
        device = resolve_device(device)
        arrays = {k: np.asarray(v) for k, v in data.items()}
        if not arrays:
            return cls(columns={}, nvalid=_i32(0, device))
        n = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if v.ndim != 1:
                raise ValueError(f"column {k!r} must be 1-D, got {v.shape}")
            if len(v) != n:
                raise ValueError("all columns must have equal length")
        cap = capacity if capacity is not None else max(n, 1)
        if cap < n:
            raise ValueError(f"capacity {cap} < number of rows {n}")
        cols = {}
        for k, v in arrays.items():
            v = narrow_column(k, v)
            buf = np.zeros(cap, v.dtype)
            buf[:n] = v
            cols[k] = torch.from_numpy(buf).to(device)
        return cls(columns=cols, nvalid=_i32(n, device))

    @classmethod
    def from_state(cls, columns: Mapping[str, np.ndarray], nvalid: int,
                   device=None) -> "Table":
        """Rebuild a table from full-capacity numpy columns (padding
        included) plus ``nvalid`` — the inverse of :meth:`state`."""
        device = resolve_device(device)
        cols = {k: torch.from_numpy(np.ascontiguousarray(
                    narrow_column(k, np.asarray(v)))).to(device)
                for k, v in columns.items()}
        return cls(columns=cols, nvalid=_i32(int(nvalid), device))

    def state(self) -> tuple[dict[str, np.ndarray], int]:
        """Full-capacity numpy columns (padding included) and ``nvalid``."""
        return ({k: v.cpu().numpy() for k, v in self.columns.items()},
                int(self.nvalid))

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Only the valid rows, on the host."""
        n = int(self.nvalid)
        return {k: v[:n].cpu().numpy() for k, v in self.columns.items()}

    def with_nvalid(self, nvalid) -> "Table":
        return Table(columns=dict(self.columns),
                     nvalid=_i32(nvalid, self.device))

    def gather_rows(self, idx: torch.Tensor, nvalid) -> "Table":
        """New table whose row ``i`` is this table's row ``idx[i]``."""
        cols = {k: v[idx] for k, v in self.columns.items()}
        return Table(columns=cols, nvalid=_i32(nvalid, self.device))

    def to_tensor(self, names: Sequence[str] | None = None) -> torch.Tensor:
        """Stage 3 of the paper: Table -> dense feature tensor, a
        ``(capacity, len(names))`` float32 tensor on the table's device
        with the padding rows zeroed."""
        names = list(names) if names is not None else list(self.names)
        mask = self.valid_mask
        return torch.stack([torch.where(mask, self.columns[n].to(
            torch.float32), 0.0) for n in names], dim=1)

    def replace_columns(self, columns: dict[str, torch.Tensor]) -> "Table":
        return Table(columns=columns, nvalid=self.nvalid)

    def pad_to(self, capacity: int) -> "Table":
        """Grow the capacity with zero padding (no-op if already there)."""
        cap = self.capacity
        if capacity < cap:
            raise ValueError("pad_to cannot shrink; use head()")
        if capacity == cap:
            return self
        cols = {k: torch.cat([v, v.new_zeros(capacity - cap)])
                for k, v in self.columns.items()}
        return Table(columns=cols, nvalid=self.nvalid)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(k, k): v for k, v in self.columns.items()}
        return Table(columns=cols, nvalid=self.nvalid)

    def add_prefix(self, prefix: str) -> "Table":
        return Table(columns={prefix + k: v for k, v in self.columns.items()},
                     nvalid=self.nvalid)

    def astype(self, dtypes: Mapping[str, torch.dtype]) -> "Table":
        cols = dict(self.columns)
        for k, dt in dtypes.items():
            cols[k] = cols[k].to(dt)
        return Table(columns=cols, nvalid=self.nvalid)

    def map_column(self, name: str,
                   fn: Callable[[torch.Tensor], torch.Tensor],
                   out: str | None = None) -> "Table":
        cols = dict(self.columns)
        cols[out or name] = fn(cols[name])
        return Table(columns=cols, nvalid=self.nvalid)


def _i32(n, device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device`` from a Python int or a tensor."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(n, dtype=torch.int32, device=device)


def null_like(col: torch.Tensor) -> torch.Tensor:
    """A column of nulls with the same shape/dtype."""
    if _is_float(col):
        return torch.full_like(col, FLOAT_NULL)
    return torch.full_like(col, INT_NULL)


def isnull_values(col: torch.Tensor) -> torch.Tensor:
    """Null sentinels of a column: NaN for floats, ``INT_NULL`` else."""
    if _is_float(col):
        return torch.isnan(col)
    return col == INT_NULL
