"""JAX's threefry2x32 generator in torch, with the same bits.

The JAX package draws every random number (energy arrivals, scheduler
appointments, minibatch indices) from ``jax.random`` keys. The port
reproduces those bits exactly, so scheduler decisions and minibatches
of the two packages can be compared bitwise. It follows the installed
jax in its ``jax_threefry_partitionable=True`` mode: ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_fold_in`` and
``_threefry_random_bits_partitionable`` in ``jax/_src/prng.py``, and
``_uniform``, ``_normal_real`` and ``_randint`` in ``jax/_src/random.py``.

A key is an explicit int64 tensor of shape ``(..., 2)`` holding the two
uint32 words of a legacy ``jax.random.PRNGKey``; leading axes batch
keys the way ``jax.vmap`` over keys would. uint32 arithmetic is emulated
in int64 (torch has no unsigned 32-bit arithmetic on every device), and
every result is masked back to 32 bits. Nothing is global state: every
draw is a pure function of its key.

``fold_in`` is what keeps per-client draws independent of the
population size (DESIGN.md §7); Philox, torch's own generator, would
neither give JAX's bits nor that property.
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Elements of a draw computed at once (:func:`_draw`): a full-width
#: embedding is 2.1e9 elements, whose int64 temporaries would each take
#: 16.8 GB; a slice's take 134 MB.
DRAW_SLICE = 1 << 24


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def _mul32(a, b):
    """``a·b mod 2**32`` for uint32 values held in int64, without
    overflowing int64 (``b`` split into 16-bit halves)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block function, 20 rounds, elementwise with
    broadcasting. All operands int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)``.

    The installed jax (64-bit mode off) keeps only the low 32 bits of
    the seed, so that is what this does too."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _on_device(x, dtype, device):
    """``x`` as a tensor on ``device``; a Python number is filled in by
    a kernel argument rather than copied from the host (a copy from
    pageable memory would wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _words(key, extra_dims: int):
    """The two key words, shaped to broadcast against ``extra_dims``
    trailing count axes."""
    pad = (1,) * extra_dims
    lead = key.shape[:-1]
    return key[..., 0].reshape(lead + pad), key[..., 1].reshape(lead + pad)


def split(key, num=2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` → ``(..., num, 2)``, or
    ``(..., *num, 2)`` for a shape tuple ``num``. The counters run over
    the flat index of the shape (JAX's ``iota_2x32_shape``), so a shape
    gives the keys of the flat split, reshaped."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    k1, k2 = _words(key, 1)
    counts = torch.arange(math.prod(shape), dtype=torch.int64,
                          device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=-1).reshape(key.shape[:-1] + shape + (2,))


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor of indices, which
    broadcasts against the key's leading axes (one key per index, as
    ``jax.vmap(lambda i: fold_in(key, i))`` gives)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def _draw(key, shape, dtype, convert, rows=None) -> torch.Tensor:
    """``convert`` of 32 random bits per element of ``shape`` (partitionable
    mode: threefry of the flat element index, words xor-ed), into a
    tensor of ``dtype``. A batched key ``(..., 2)`` gives ``(...,) +
    shape``. The flat index is drawn ``DRAW_SLICE`` elements at a time,
    so the int64 and float64 temporaries of a draw stay a slice's size
    however large the draw; each element depends on its index alone, so
    the slices give the bits of one draw. ``rows``, a slice of the
    leading axis of ``shape``, draws those rows alone: their bits in the
    whole draw."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2**32 random words in one draw")
    first, last = 0, n
    if rows is not None:
        r0, r1, step = rows.indices(shape[0])
        if step != 1:
            raise ValueError(f"rows must be a contiguous slice, got {rows}")
        inner = n // shape[0] if shape[0] else 0
        shape = (max(r1 - r0, 0),) + shape[1:]
        first, last = r0 * inner, r0 * inner + math.prod(shape)
    k1, k2 = _words(key, 1)
    lead = key.shape[:-1]
    if last - first <= DRAW_SLICE:
        lo = torch.arange(first, last, dtype=torch.int64, device=key.device)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        return convert(b1 ^ b2).reshape(lead + shape)
    out = torch.empty(lead + (last - first,), dtype=dtype, device=key.device)
    for start in range(first, last, DRAW_SLICE):
        lo = torch.arange(start, min(last, start + DRAW_SLICE),
                          dtype=torch.int64, device=key.device)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        out[..., start - first:start - first + lo.numel()] = convert(b1 ^ b2)
    return out.reshape(lead + shape)


def random_bits(key, shape=()) -> torch.Tensor:
    """32 random bits per element of ``shape``, held in int64. A batched
    key ``(..., 2)`` gives ``(...,) + shape``."""
    return _draw(key, shape, torch.int64, lambda bits: bits)


def _uniform_from_bits(bits, lo, hi):
    """``jax.random.uniform``'s float32 from 32 random bits: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled into
    ``[lo, hi)``."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # XLA contracts the scale-and-shift into one fused multiply-add. The
    # f32 product is exact in f64, so an f64 add rounded to f32 gives the
    # fused result (barring a double-rounding tie). For the ranges the
    # port draws from, [0, 1), (-1, 1) and [0.5, 1.5), the product is
    # exact in f32 and both roundings agree.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``."""
    lo = _on_device(minval, torch.float32, key.device)
    hi = _on_device(maxval, torch.float32, key.device)
    return _draw(key, shape, torch.float32,
                 lambda bits: _uniform_from_bits(bits, lo, hi))


def normal(key, shape=(), rows=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``√2·erfinv(u)`` with ``u``
    uniform on the open interval (−1, 1). The uniform bits are JAX's;
    ``erfinv`` is torch's, so values agree to a few ulps, not bitwise.
    ``rows`` (a slice of the leading axis) draws those rows of the whole
    draw alone (:func:`_draw`)."""
    lo = _on_device(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item(),
                    torch.float32, key.device)
    hi = _on_device(1.0, torch.float32, key.device)
    return _draw(key, shape, torch.float32,
                 lambda bits: torch.erfinv(_uniform_from_bits(bits, lo, hi))
                 * math.sqrt(2.0), rows=rows)


def randint(key, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` into int32: two 32-bit words per value,
    reduced modulo the span the way jax does it (uint32 wrap-around
    included), so the same key gives the same integers."""
    shape = tuple(shape)
    for bound in (minval, maxval):
        if isinstance(bound, int) and not -2 ** 31 <= bound < 2 ** 31:
            raise ValueError(f"randint bound {bound} does not fit in int32")
    minval, maxval = (_on_device(b, torch.int64, key.device)
                      for b in (minval, maxval))
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & _MASK)
    multiplier = (2 ** 16) % span
    multiplier = _mul32(multiplier, multiplier) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & _MASK
    offset = offset % span
    return (minval + offset).to(torch.int32)
