"""Counter-based random numbers of the port: JAX's threefry2x32 keys and
draws, bit for bit, in PyTorch integer ops.

The significance stage's p-values depend on every surrogate draw and on
the library-subsampling permutation, so the port reproduces the JAX
package's ``jax.random`` calls exactly rather than drawing from a
``torch.Generator``.  A key is an int64 tensor of shape (..., 2) holding
two 32-bit words; every function takes its key (or a batch of keys in
the leading dimensions) explicitly and runs on the key's device.  Only
integer ops are used (the float step of :func:`uniform` is a bit cast
and three float32 ops), so the card and the CPU give the same bits.

Semantics are those of ``jax_threefry_partitionable = True`` (the JAX
default): ``split`` and ``random_bits`` hash the flat index of each
output element, as a 64-bit counter split into (hi, lo) words, under the
key, and a 32-bit draw is the XOR of the two output words.  ``fold_in``
hashes the counter (0, data).  ``permutation`` is JAX's ``_shuffle``:
``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a stable sort of the
values by fresh 32-bit keys from a split subkey.

Words are held in int64 and masked to 32 bits after every add and shift:
PyTorch has no shifts on ``torch.uint32`` on the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32(2 pi), the ``maxval`` of the phase draws (``2.0 * jnp.pi``)
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds, the block function of
    ``jax.random``.  Keys and counters are int64 tensors of 32-bit words
    that broadcast against each other."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF)
    of a 64-bit integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def _hash_iota(key: torch.Tensor, n: int):
    """threefry(key, (hi(i), lo(i))) for i < n; key (..., 2) -> two
    (..., n) word tensors."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], i >> 32, i & MASK32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    b0, b1 = _hash_iota(key, num)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2) and data (an int, or an int
    tensor broadcasting against the key's leading dims) -> (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2**32):
    key (..., 2) -> (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    b0, b1 = _hash_iota(key, math.prod(shape))
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of a draw set
    the mantissa of a float in [1, 2), then ``- 1``, ``* (max - min)``,
    ``+ min``, clamped below at ``min``."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def shuffle_rounds(n: int) -> int:
    """Sort rounds of JAX's ``_shuffle`` for n values."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation(key, x)``: an int n shuffles arange(n);
    a tensor x is shuffled along its last dimension.  Keys (..., 2) give
    one independent shuffle each, as ``vmap`` of ``permutation`` over
    split keys does: x is (n,) (shared) or (..., n) (one row per key)."""
    if isinstance(x, int):
        x = torch.arange(x, dtype=torch.int64, device=key.device)
    n = x.shape[-1]
    if x.dim() == 1:
        x = x.expand(key.shape[:-1] + (n,))
    elif x.shape[:-1] != key.shape[:-1]:
        raise ValueError(f"permutation: x {tuple(x.shape)} does not match "
                         f"keys {tuple(key.shape)}")
    for _ in range(shuffle_rounds(n)):
        pair = split(key, 2)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
