"""``jax.random``'s threefry2x32 bit streams in torch.

The JAX package draws its bagging masks, GOSS samples and the stochastic
rounding of quantized gradients from ``jax.random`` (threefry2x32, with
``jax_threefry_partitionable`` on, its default since jax 0.5). The port
reproduces those bits exactly, so the same seed samples the same rows and
rounds the same gradients:

* :func:`PRNGKey` is ``jax.random.PRNGKey`` (``prng.py threefry_seed``; a
  seed wraps to 32 bits as it does in JAX's 32-bit mode);
* :func:`split` is ``jax.random.split`` (``_threefry_split_foldlike``:
  the hash of the 64-bit iota of the output shape);
* :func:`uniform` is ``jax.random.uniform`` over [0, 1) in float32
  (``_threefry_random_bits_partitionable`` then ``random.py _uniform``:
  the two hash words XORed, the top 23 bits as the mantissa of a float in
  [1, 2), minus 1).

A key is an int64 tensor ``[2]`` holding two uint32 words (torch's uint32
support is thin, above all on CUDA, so every 32-bit operation runs in int64
and is masked with ``0xFFFFFFFF``). Keys are tiny and stay on the CPU;
:func:`uniform` reads the key's two words on the host and hashes its
counters on the requested device, so a draw of N numbers is some 100
elementwise torch ops over N int64 values and no host read.

This is the XLA side of the JAX package, not one of its Pallas kernels:
plain torch ops on the device are the port. ``fold_in`` and ``randint``
come with extra_trees and by-node sampling, in a later slice.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _hash(k1: int, k2: int, x0: torch.Tensor,
          x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter pairs (x0, x1) under key (k1, k2): 20
    rounds with a key injection every 4 (``prng.py
    _threefry2x32_lowering``). x0, x1: int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.tolist()
    if len(k) != 2:
        raise ValueError(f"a threefry key has two words, got shape "
                         f"{tuple(key.shape)}")
    return int(k[0]) & _MASK, int(k[1]) & _MASK


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota 0..n-1 as (high words, low words)
    (``prng.py iota_2x32_shape``)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (0, seed mod 2^32) — JAX's
    32-bit mode first wraps the seed to int32, whose logical shift by 32
    is 0."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> int64 ``[num, 2]`` on the key's
    device."""
    k1, k2 = _words(key)
    hi, lo = _counters(num, key.device)
    b0, b1 = _hash(k1, k2, hi, lo)
    return torch.stack([b0, b1], dim=1)


def uniform(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) on ``device``
    (the key's device when None)."""
    shape = _shape(shape)
    k1, k2 = _words(key)
    hi, lo = _counters(math.prod(shape),
                       key.device if device is None else device)
    b0, b1 = _hash(k1, k2, hi, lo)
    # 32 random bits per element (the two words XORed); the top 23 under
    # the exponent of 1.0 make a float in [1, 2)
    fbits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (fbits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
