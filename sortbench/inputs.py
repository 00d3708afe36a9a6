"""The one traffic generator: every call's inputs, from a traffic mix's
parameters, a configuration's types and the seed.

Keys are made on the device by a ``torch.Generator`` seeded from
``--seed`` (and the rank), in one call for the whole pool, so the same
seed gives the same inputs. Distributions (``keys.dist``):

- ``uniform``: every bit pattern of the key's width equally likely
  (floats included: negatives, infinities and NaNs);
- ``zipf``: ``min(zipf(a), cap)`` for integer keys, drawn by the
  rejection method numpy's ``Generator.zipf`` uses, on the device.

Values (the configuration's ``values``): ``"arange"``, ``values[i] = i``
in the value's width, as the reference's SortPairs makes them.
"""

from __future__ import annotations

import torch

DTYPES = {
    "uint8": torch.uint8, "int8": torch.int8, "uint16": torch.uint16,
    "int16": torch.int16, "uint32": torch.uint32, "int32": torch.int32,
    "uint64": torch.uint64, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64,
}
SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of one rank's inputs (rank 0's is seeded by the seed
    itself; every rank's is a function of the seed alone)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + int(rank) * 0x9E3779B97F4A7C15) % (1 << 64))
    return gen


def random_words(count: int, nbytes: int, gen, device) -> torch.Tensor:
    """``count`` signed words of ``nbytes`` bytes, every bit pattern
    equally likely."""
    if nbytes == 8:
        return random_words(2 * count, 4, gen, device).view(torch.int64)
    lo = -(1 << (8 * nbytes - 1))
    return torch.empty(count, dtype=SIGNED[nbytes], device=device).random_(
        lo, -lo, generator=gen)


def _zipf(count: int, a: float, cap: int, gen, device) -> torch.Tensor:
    """``min(zipf(a), cap)`` as int64: numpy's rejection sampler
    (Devroye, Non-Uniform Random Variate Generation, p. 551), on the
    device, redrawing the rejected draws until none is left."""
    am1, b = a - 1.0, 2.0 ** (a - 1.0)
    out = torch.empty(count, dtype=torch.int64, device=device)
    todo = torch.arange(count, device=device)
    while todo.numel():
        u = 1.0 - torch.rand(todo.numel(), dtype=torch.float64,
                             generator=gen, device=device)
        v = torch.rand(todo.numel(), dtype=torch.float64, generator=gen,
                       device=device)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x < 2.0 ** 62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = torch.clamp(x[ok], max=float(cap)).to(torch.int64)
        todo = todo[~ok]
    return out


def keys(traffic: dict, config: dict, gen, device) -> torch.Tensor:
    """The pool of keys: ``(pool, n)``, each row one call's keys."""
    dtype = DTYPES[config["key_dtype"]]
    width = dtype.itemsize
    pool, n = int(traffic["pool"]), int(traffic["n"])
    spec = dict(traffic["keys"])
    dist = spec.pop("dist")
    count = pool * n
    if dist == "uniform":
        words = random_words(count, width, gen, device)
    elif dist == "zipf":
        if dtype.is_floating_point:
            raise ValueError("zipf keys are integers")
        z = _zipf(count, float(spec["a"]), int(spec["cap"]), gen, device)
        words = z.to(SIGNED[width]) if width < 8 else z
    else:
        raise ValueError(f"unknown key distribution {dist!r}")
    return words.view(dtype).view(pool, n)


def values(traffic: dict, config: dict, device):
    """One call's payload, the same for every call, or None."""
    kind = config["values"]
    if kind is None:
        return None
    dtype = DTYPES[config["value_dtype"]]
    n = int(traffic["n"])
    if kind == "arange":
        if dtype.is_floating_point or n > 1 << (8 * dtype.itemsize):
            raise ValueError(f"arange({n}) does not fit {dtype}")
        return torch.arange(n, dtype=torch.int64, device=device).to(
            SIGNED[dtype.itemsize]).view(dtype)
    raise ValueError(f"unknown values {kind!r}")
