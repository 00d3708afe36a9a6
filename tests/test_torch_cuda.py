"""The hand-written CUDA sweep kernel on the card: against its plain PyTorch
version, through the public entry points, and its input checks. Marked
``cuda``; each test skips where ``torch.cuda.is_available()`` is false.

On a machine with an NVIDIA Hopper GPU:
``python -m pytest tests/test_torch_cuda.py -m cuda -q``

The file imports nothing from ``tests``, so it also runs where another
package named ``tests`` is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
from tinyhipradixsort_torch.ops import bitonic_engine as tbe

pytestmark = pytest.mark.cuda


def _oracle_perm(x, descending):
    return np.argsort(tthrs.np_key_bits(x, descending=descending),
                      kind="stable")


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        a = a.view({4: torch.int32, 8: torch.int64}[a.dtype.itemsize]).numpy()
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _rand_keys(rng, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        x[rng.random(n) < 0.05] = -0.0
        x[rng.random(n) < 0.05] = np.nan
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, dtype=dtype,
                        endpoint=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("nwords,ncmp", [(1, 1), (3, 3), (5, 3)])
def test_kernel_matches_plain_version_on_every_sweep(cuda, nwords, ncmp):
    L = 18
    rng = np.random.default_rng(nwords)
    words = [rng.integers(0, 16, size=1 << L, dtype=np.uint32)]
    words += [rng.integers(0, 2**32, size=1 << L, dtype=np.uint32)
              for _ in range(nwords - 1)]
    tuning = tbe.EngineTuning()
    T = tbe._tile_bits_for(nwords, L, tuning)
    sweeps = tbe.plan_sweeps(L, T, T, g_max_cross=tuning.cross_g_max)
    sweeps.append(dataclasses.replace(sweeps[1], forced_asc=T + 1))
    for sweep in sweeps:
        dev = [torch.from_numpy(w).view(torch.int32).to(cuda) for w in words]
        before = tbe.KERNEL_LAUNCHES
        got = tbe.run_sweep([w.clone() for w in dev], sweep, ncmp)
        assert tbe.KERNEL_LAUNCHES == before + 1
        want = tbe.run_sweep_reference(dev, sweep, ncmp)
        for g, w in zip(got, want):
            assert torch.equal(g, w), sweep


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint64, np.int64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_sorts_on_the_card_match_the_oracle(cuda, dtype):
    rng = np.random.default_rng(11)
    for n in (1000, 1 << 17):
        x = _rand_keys(rng, dtype, n)
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        xd = torch.from_numpy(x).to(cuda)
        before = tbe.KERNEL_LAUNCHES
        for desc in (False, True):
            order = "descending" if desc else "ascending"
            perm = _oracle_perm(x, desc)
            k, v = tthrs.sort_pairs(xd, torch.from_numpy(vals).to(cuda),
                                    order=order)
            assert k.is_cuda and v.is_cuda
            np.testing.assert_array_equal(_bits(k), _bits(x[perm]))
            np.testing.assert_array_equal(v.cpu().numpy(), vals[perm])
            np.testing.assert_array_equal(
                tthrs.sort_indices(xd, order=order).cpu().numpy(), perm)
        assert tbe.KERNEL_LAUNCHES > before
        np.testing.assert_array_equal(_bits(xd), _bits(x))


def test_kernel_refuses_what_it_does_not_take(cuda):
    sweep = tbe.plan_sweeps(10, 10, 10)[0]
    good = torch.zeros(1024, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tbe.run_sweep([good.to(torch.int64)], sweep, 1)
    with pytest.raises(ValueError):
        tbe.run_sweep([torch.zeros(2048, dtype=torch.int32,
                                   device=cuda)[::2]], sweep, 1)
    with pytest.raises(ValueError):
        tbe.run_sweep([good, good.cpu()], sweep, 1)
    with pytest.raises(ValueError):
        tbe.run_sweep([good], sweep, 2)
