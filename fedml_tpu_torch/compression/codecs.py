"""Wire codecs — counterpart of ``fedml_tpu/compression/codecs.py``.

This module holds only what the 4-bit weight format
(``ops/quant.QuantizedTensor4``) shares with the ``nf4`` wire codec: the
NF4 codebook and the midpoints its nearest-codeword binning uses. The wire
codecs themselves (``CompressedTree``, identity, bf16, int8, top-k, int4,
nf4, ``fused_weighted_sum``) come with the aggregation wire, ROADMAP A8,
which extends this file.
"""
from __future__ import annotations

import numpy as np

# NF4: the 16-entry normal-float codebook of Dettmers et al. 2023 —
# quantiles of N(0,1) rescaled so the range is exactly [-1, 1] and zero
# is representable. Codes are indices into this table.
NF4_CODEBOOK = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], np.float32)
# nearest-codeword binning: code = #{midpoints below v}
_NF4_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2.0
