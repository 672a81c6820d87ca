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
  [1, 2), minus 1);
* :func:`fold_in` is ``jax.random.fold_in`` (``_threefry_fold_in``: the
  key's hash of the counter pair (0, data));
* :func:`randint` is ``jax.random.randint`` for 32-bit integers
  (``random.py _randint``: the key split in two, 32 random bits drawn from
  each, folded together modulo the span with the multiplier
  ``(2^16 mod span)^2 mod span``, all in uint32 arithmetic, plus
  ``minval``), computed on the host in numpy.

``split``, ``uniform`` and ``fold_in`` also take a batch of keys ``[n, 2]``
and give each key's result along a leading axis: ``jax.vmap`` of the same
call over the keys. ``RankXENDCG`` draws one uniform vector per query that
way, with no host read per key.

A key is an int64 tensor ``[2]`` holding two uint32 words (torch's uint32
support is thin, above all on CUDA, so every 32-bit operation runs in int64
and is masked with ``0xFFFFFFFF``). Keys are tiny and stay on the CPU;
:func:`uniform` reads a single key's two words on the host (a batch of
keys moves to the requested device instead) and hashes its counters
there, so a draw of N numbers is some 100 elementwise torch ops over N
int64 values and no host read.

This is the XLA side of the JAX package, not one of its Pallas kernels:
plain torch ops on the device are the port.

The tree learner draws a few numbers per leaf (extra_trees thresholds and
by-node feature masks over the F features). Those draws run on the host
in numpy (:func:`randint`, :func:`uniform_host`, the same hash over the
same counters), and :func:`split` and :func:`fold_in` of a single key
hash Python integers, so a split step pays microseconds for its keys and
no device launch.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


Words = Union[int, torch.Tensor]


def _hash(k1: Words, k2: Words, x0: torch.Tensor,
          x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter pairs (x0, x1) under key (k1, k2): 20
    rounds with a key injection every 4 (``prng.py
    _threefry2x32_lowering``). x0, x1: int64 tensors of uint32 values; the
    key words are ints, or int64 tensors that broadcast against them."""
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


def _words(key: torch.Tensor, device=None) -> Tuple[Words, Words]:
    """A key's two words: Python ints for one key ``[2]`` (one host read of
    a CPU tensor), int64 ``[n, 1]`` tensors on ``device`` for a batch
    ``[n, 2]``."""
    if key.dim() == 2 and key.shape[1] == 2:
        k = key.to(device if device is not None else key.device)
        return k[:, :1] & _MASK, k[:, 1:] & _MASK
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
    device (``[n, num, 2]`` for a batch of keys ``[n, 2]``)."""
    k1, k2 = _words(key)
    if isinstance(k1, int) and num <= 16:
        # a single key: hash the counters as Python integers
        return torch.tensor([_hash(k1, k2, 0, i) for i in range(num)],
                            dtype=torch.int64, device=key.device)
    hi, lo = _counters(num, key.device)
    b0, b1 = _hash(k1, k2, hi, lo)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` -> int64 ``[2]`` on the key's
    device (``[n, 2]`` for a batch of keys): the hash of the counter pair
    (0, data), ``data`` wrapped to 32 bits."""
    k1, k2 = _words(key)
    if isinstance(k1, int):
        return torch.tensor(_hash(k1, k2, 0, int(data) & _MASK),
                            dtype=torch.int64, device=key.device)
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    b0, b1 = _hash(k1, k2, zero, zero + (int(data) & _MASK))
    out = torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)
    return out.reshape(-1, 2) if key.dim() == 2 else out.reshape(2)


def uniform(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) on ``device``
    (the key's device when None); ``[n, *shape]`` for a batch of keys
    ``[n, 2]``, each row the draw of its own key."""
    shape = _shape(shape)
    dev = key.device if device is None else device
    k1, k2 = _words(key, dev)
    hi, lo = _counters(math.prod(shape), dev)
    # 32 random bits per element (the two words XORed); the top 23 under
    # the exponent of 1.0 make a float in [1, 2)
    fbits = (_bits(k1, k2, hi, lo) >> 9) | 0x3F800000
    out = fbits.to(torch.int32).view(torch.float32) - 1.0
    return out.reshape((-1,) + shape if key.dim() == 2 else shape)


def _bits(k1, k2, hi, lo):
    """32 random bits per counter (``_threefry_random_bits_partitionable``:
    the two hash words XORed), in the arrays' own type."""
    b0, b1 = _hash(k1, k2, hi, lo)
    return b0 ^ b1


def _span_mod(higher, lower, minval: int, maxval: int):
    """``_randint``'s fold of two 32-bit draws into [minval, maxval), in
    uint32 arithmetic on int64 arrays (torch or numpy): the low 32 bits of
    an int64 product are those of the unsigned one even when it wraps."""
    lo_ = max(min(int(minval), 2**31 - 1), -2**31)
    hi_ = max(min(int(maxval), 2**31 - 1), -2**31)
    span = (hi_ - lo_) & _MASK if hi_ > lo_ else 1
    mult = ((2**16 % span) ** 2 & _MASK) % span
    off = ((((higher % span) * mult) & _MASK) + (lower % span)) & _MASK
    return lo_ + off % span


def _host_words(keys: np.ndarray):
    k = np.asarray(keys, dtype=np.int64).reshape(-1, 2) & _MASK
    return k[:, :1], k[:, 1:]


def uniform_host(keys: np.ndarray, n: int) -> np.ndarray:
    """:func:`uniform` of each key of ``keys`` (int64 ``[k, 2]``) over
    ``n`` counters, computed on the host in numpy: float32 ``[k, n]``."""
    k1, k2 = _host_words(keys)
    idx = np.arange(n, dtype=np.int64)[None, :]
    fbits = (_bits(k1, k2, idx >> 32, idx & _MASK) >> 9) | 0x3F800000
    return fbits.astype(np.uint32).view(np.float32) - np.float32(1.0)


def randint(keys, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, scalar
    bounds) of one key ``[2]``, or of each key of a batch ``[k, 2]`` (int64,
    a CPU tensor or a numpy array), computed on the host in numpy: int64
    ``shape``, or ``[k, *shape]`` for a batch."""
    shape = _shape(shape)
    keys = np.asarray(keys, dtype=np.int64)
    k1, k2 = _host_words(keys)
    sub = [[_hash(int(a), int(b), 0, i) for i in (0, 1)]
           for a, b in zip(k1[:, 0], k2[:, 0])]
    sub = np.asarray(sub, dtype=np.int64)           # [k, 2 subkeys, 2]
    idx = np.arange(math.prod(shape), dtype=np.int64)[None, :]
    hi, lo = idx >> 32, idx & _MASK
    out = _span_mod(_bits(sub[:, 0, :1], sub[:, 0, 1:], hi, lo),
                    _bits(sub[:, 1, :1], sub[:, 1, 1:], hi, lo), minval,
                    maxval)
    return out.reshape(((-1,) if keys.ndim == 2 else ()) + shape)
