"""Tuning table for the radix digit pass (port of
``repro/kernels/autotune.py``).

Two static knobs shape the radix engine (``kernels/radix_sort``):

* ``radix_bits`` — digit width of one LSD pass, 1 to 11: more bits means
  fewer passes but a wider per-tile histogram (``2**radix_bits`` counts
  per warp in shared memory, 64 KB at 11 bits);
* ``tile`` — rows per CUDA block of the digit kernel.  The kernel is
  built for 512, 1024 and 2048 rows (2, 4 or 8 rows per thread); any
  other value raises.

Resolution order, as in the reference:

1. ``REPRO_RADIX_BITS`` / ``REPRO_TILE`` environment overrides;
2. the process-local cache, keyed by ``(knob, backend, dtype,
   capacity_bucket)`` with the capacity rounded up to a power of two;
3. with ``REPRO_AUTOTUNE=1``, a first-use sweep over the candidates:
   one warm-up and one timed ``radix_permutation`` per candidate on a
   synthetic column, on the card for the ``cuda`` backend (the digit
   kernel itself is what is timed) and on the CPU for ``ref``;
4. otherwise the per-backend default.

Backends are ``ref`` (CPU tensors, plain versions) and ``cuda``.
"""
import os
import time

import torch

_DEFAULTS = {
    "radix_bits": {"ref": 8, "cuda": 8},
    "tile": {"ref": 1024, "cuda": 1024},
}
_CANDIDATES = {
    "radix_bits": (4, 8, 11),
    "tile": (512, 1024, 2048),
}
# the tiles the CUDA digit kernel is instantiated for
TILES = _CANDIDATES["tile"]
MAX_RADIX_BITS = 11
_ENV = {"radix_bits": "REPRO_RADIX_BITS", "tile": "REPRO_TILE"}
_SWEEP_CAP = 1 << 16   # rows of synthetic data per timed candidate

_cache: dict = {}


def clear_cache() -> None:
    """Drop all cached tuning decisions (tests / fresh sweeps)."""
    _cache.clear()


def _env_int(name: str):
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def _capacity_bucket(capacity: int) -> int:
    return 1 << max(0, int(capacity - 1).bit_length()) if capacity > 1 else 1


def _check(knob: str, value: int) -> int:
    """Raise unless ``value`` is one the digit kernel is built for."""
    if knob == "tile" and value not in TILES:
        raise ValueError(f"tile {value}: the radix digit kernel is built for "
                         f"{TILES} rows per block")
    if knob == "radix_bits" and not 1 <= value <= MAX_RADIX_BITS:
        raise ValueError(f"radix_bits {value}: the radix digit kernel takes "
                         f"1 to {MAX_RADIX_BITS} bits per pass")
    return value


def _sweep(knob: str, backend: str, capacity: int) -> int:
    """Time each candidate on a synthetic column; return the fastest."""
    from .radix_sort.ops import _radix_permutation

    device = torch.device("cuda" if backend == "cuda" else "cpu")
    n = max(8, min(capacity, _SWEEP_CAP))
    # a Weyl sequence: every digit pass sees well-spread words
    col = ((torch.arange(n, dtype=torch.int64, device=device) * 2654435761)
           & 0xFFFFFFFF).to(torch.int32)
    invalid = torch.zeros(n, dtype=torch.bool, device=device)
    best, best_t = None, None
    for cand in _CANDIDATES[knob]:
        kw = {"radix_bits": _DEFAULTS["radix_bits"][backend],
              "tile": _DEFAULTS["tile"][backend], knob: cand}

        def run(kw=kw):
            _radix_permutation((col,), invalid, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        run()                                   # warm-up (and build)
        t0 = time.perf_counter()
        run()
        t = time.perf_counter() - t0
        if best_t is None or t < best_t:
            best, best_t = cand, t
    return best


def tuned(knob: str, backend: str, capacity: int,
          dtype: str = "int32") -> int:
    """Resolve ``knob`` ('radix_bits' | 'tile') for one call at
    ``capacity`` rows on ``backend`` ('ref' | 'cuda')."""
    env = _env_int(_ENV[knob])
    if env is not None:
        return _check(knob, env)
    key = (knob, backend, str(dtype), _capacity_bucket(capacity))
    if key not in _cache:
        if os.environ.get("REPRO_AUTOTUNE", "") == "1":
            _cache[key] = _sweep(knob, backend, key[3])
        else:
            _cache[key] = _DEFAULTS[knob][backend]
    return _cache[key]


def radix_params(backend: str, capacity: int, radix_bits=None, tile=None):
    """(radix_bits, tile), each ``None`` resolved through :func:`tuned`;
    explicit values are checked like the overrides."""
    radix_bits = tuned("radix_bits", backend, capacity) \
        if radix_bits is None else _check("radix_bits", radix_bits)
    tile = tuned("tile", backend, capacity) if tile is None \
        else _check("tile", tile)
    return radix_bits, tile
