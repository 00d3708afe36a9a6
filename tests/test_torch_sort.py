"""Sort parity of the PyTorch port with the JAX package: ``sort_keys``,
``sort_pairs`` and ``sort_indices`` over six key dtypes, both orders and
sizes from 0 to 4097 (padded, exact power of two, and the sizes the JAX
package routes through its segmented merge).

The JAX side runs as its own tests run it: ``method="pallas"``, interpreted
on the CPU. Its stable permutation fixes every output (keys, payloads and
indices are unique under a stable sort), so one JAX call per input serves
all three entry points. Comparisons are bit-exact on unsigned views.
"""

import numpy as np
import pytest

from tests.torch_helpers import check_parity


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_parity_32bit_keys(dtype, order):
    check_parity(dtype, order)
