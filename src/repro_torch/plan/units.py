"""Words to bytes: the port's one unit conversion.

The planner counts words, the paper's currency. A byte count is a word count
times the width of one element; wherever the port takes that width from a
dtype or a workload (``itemsize``, ``word_bytes``), the product is a call to
`nbytes`, so such a multiplication anywhere else is a unit error that lint
finds (`tests/test_torch_lint.py`). The kernels' shared-memory sizers, which
mirror CUDA layouts of fixed fp32 elements, keep their literal widths.
"""

from __future__ import annotations


def nbytes(words, itemsize):
    """Bytes of ``words`` elements ``itemsize`` bytes wide (ints or int
    arrays; the result has the operands' type)."""
    return words * itemsize
