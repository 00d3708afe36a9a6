"""Sort parity of the PyTorch port with the JAX package for 64-bit keys
(two compare words); see ``test_torch_sort.py`` for the method."""

import numpy as np
import pytest

from tests.torch_helpers import check_parity


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_parity_64bit_keys(dtype, order):
    check_parity(dtype, order, seed=64)
