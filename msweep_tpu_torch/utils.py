"""Small host utilities: the log(0) stand-in, the padding threshold, and
the integer-width choice for count tables.

The reference's adaptive integer-width dispatch (include/Likelihood.hpp:334-380,
src/Grouping.cpp:46-88) becomes the numpy dtype chosen by
:func:`min_uint_dtype`.
"""

from __future__ import annotations

import numpy as np

# Large negative stand-in for log(0).  Finite, so NEG - NEG = 0 stays
# NaN-free, and exp(NEG + anything reasonable) underflows to exactly 0.0
# in float32 and float64.
NEG = -1.0e8

# Entries below this are padding (real log-likelihood values are
# O(k log n), never anywhere near NEG).
PAD_THRESHOLD = NEG * 0.5


def min_uint_dtype(max_value: int) -> np.dtype:
    """Smallest unsigned integer dtype that can hold `max_value`."""
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    raise ValueError(f"value {max_value} too large")
