"""Reference-density tier of the PyTorch port (``pytest --full``): the
port's drive (``tinyhipradixsort_torch.tools.drive``) with 64 random sizes
per (dtype x order) in [1, 100000), the pairs matrix, random u64 windows
and the ``np_key_bits`` adapter cases, as ``tests/test_full_matrix.py``
does for the JAX package (reference: unittest.cpp TEST_ITERATION).

On the CPU it runs ``argsort``, ``counting`` and ``bitonic`` (the plain
twin of the sweep kernel); on the card, marked ``cuda``, the bitonic
engine through its kernel:

    python -m pytest tests/test_torch_full_matrix.py --full -q
"""

import pytest
import torch

from tinyhipradixsort_torch.tools import drive

pytestmark = pytest.mark.full

ITER = 64


def _no_failures(dev: str, method: str) -> None:
    lines = []
    d = drive.drive(dev, method, iters=ITER, out=lines.append)
    assert d.fails == 0, "\n".join(lines)


@pytest.mark.parametrize("method", ["argsort", "counting", "bitonic"])
def test_full_drive_on_the_cpu(method):
    _no_failures("cpu", method)


@pytest.mark.cuda
def test_full_drive_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    _no_failures("cuda", "bitonic")
