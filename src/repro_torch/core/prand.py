"""Counter-based randomness that reproduces ``jax.random`` bit for bit.

The reference simulator draws every random number through
``jax.random`` with the default threefry2x32 generator. To let the port
run from the same key and make the same choices, this module rebuilds
that generator from torch integer ops.

**Pinned variant.** These functions follow ``jax.random`` as jax 0.9.0
runs it with ``jax_threefry_partitionable=True`` (its default):

* 32-bit draws are ``bits1 ^ bits2`` where ``(bits1, bits2) =
  threefry2x32(key, iota_2x32_shape(shape))``, the counter being the
  row-major index split into (high, low) 32-bit words
  (``jax._src.prng._threefry_random_bits_partitionable``);
* ``split`` is the fold-like variant: sub-key ``i`` is
  ``threefry2x32(key, (0, i))`` (``_threefry_split_foldlike``), which
  makes ``split(key, n)[i] == fold_in(key, i)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, uint32(d)))``;
* ``uniform`` fills the mantissa of a float in [1, 2) and subtracts 1,
  ``normal`` is ``sqrt(2)·erfinv(uniform(nextafter(-1, 0), 1))``,
  ``gumbel`` is ``-log(-log(uniform(tiny, 1)))``, ``permutation``
  sorts ``arange(n)`` on random uint32 keys (``jax.random._shuffle``),
  and ``choice`` without replacement is a permutation's head.

With the flag False every draw changes. ``normal`` and ``gumbel`` go
through ``erfinv``/``log``; they use ``core.fmath``, which replays the
reference's float32 polynomials FMA for FMA, so the floats match too.

**Layout.** A key is an int64 tensor of shape ``(..., 2)`` holding two
uint32 words (torch's ``uint32`` lacks most ops, so the lanes are int64
masked to 32 bits). Leading key axes batch: every function maps over
them the way ``jax.vmap`` would, and draws of ``shape`` come out as
``key.shape[:-1] + shape``.

**Player-indexed draws.** The ``player_*`` helpers key each draw as
``fold_in(key, player_id)`` so a player's numbers depend only on its
global id and the step key (see ``repro/core/prand.py``); ``pids`` is
the (K,) tensor of global player ids.

These are plain torch ops; on the card each is a small elementwise
kernel. They are not a TPU kernel of the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import fmath

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as jax builds it with 64-bit mode off
    (the reference's setting): the seed wraps to 32 bits, high word 0."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as jax's unrolled lowering.

    All arguments are int64 tensors of uint32 values that broadcast
    together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_counts(key: torch.Tensor, shape: tuple) -> tuple:
    """threefry2x32(key, iota_2x32_shape(shape)) for a batch of keys."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2**32 or more elements")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + pad)
    k2 = key[..., 1].reshape(key.shape[:-1] + pad)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (int or int tensor) broadcasts
    against the key's batch axes."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack((y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like): ``(..., num, 2)`` sub-keys."""
    y1, y2 = _hash_counts(key, (num,))
    return torch.stack((y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32-bit draws as int64 values in [0, 2**32)."""
    y1, y2 = _hash_counts(key, tuple(shape))
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: bit for bit."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo        # float32 arithmetic, as in jax
    out = fmath.fma(floats, float(scale), float(lo))   # contracted by XLA
    return torch.clamp_min(out, float(lo))


def normal(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * fmath.erfinv(u)


def gumbel(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    return -fmath.log(-fmath.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax(logits + g)."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: stable sorts of ``arange(n)``
    on fresh uint32 keys, as many rounds as ``jax.random._shuffle``."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(key.shape[:-1] + (n,))
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    for _ in range(rounds):
        sub = split(key)
        key, subkey = sub[..., 0, :], sub[..., 1, :]
        order = torch.sort(random_bits(subkey, (n,)), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x


def choice(key: torch.Tensor, n: int, count: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (count,), replace=False)``: jax takes
    the first ``count`` entries of ``permutation(key, n)``."""
    if not 0 <= count <= n:
        raise ValueError(f"cannot take {count} of {n} without replacement")
    return permutation(key, n)[..., :count]


def player_normal(key: torch.Tensor, pids: torch.Tensor) -> torch.Tensor:
    """(K,) standard normal, one per player id."""
    return normal(fold_in(key[..., None, :], pids))


def player_uniform(key: torch.Tensor, pids: torch.Tensor) -> torch.Tensor:
    """(K,) uniform [0, 1), one per player id."""
    return uniform(fold_in(key[..., None, :], pids))


def player_uniform_row(key: torch.Tensor, pids: torch.Tensor,
                       n: int) -> torch.Tensor:
    """(K, n) uniform [0, 1), one row per player id."""
    return uniform(fold_in(key[..., None, :], pids), (n,))


def player_gumbel(key: torch.Tensor, pids: torch.Tensor, n: int) -> torch.Tensor:
    """(K, n) standard Gumbel, one row per player id."""
    return gumbel(fold_in(key[..., None, :], pids), (n,))
