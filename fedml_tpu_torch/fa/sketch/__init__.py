"""Federated analytics on the masked wire: mergeable sketch codecs —
counterpart of ``fedml_tpu/fa/sketch``.

Client data never leaves as plaintext: each client folds its items into a
linear sketch (count-min / count-sketch tables, Bloom bit-vectors,
fixed-bin histograms, TrieHH vote vectors), ships it as a
``CompressedTree`` under a server-negotiated codec spec, and the server
reduces the cohort through the fused weighted sum, SecAgg and the tree.
Every sketch is mergeable: merge(A, B) == sketch(items_A + items_B).

- :mod:`.sketches` — host numpy sketch structures and estimators;
- :mod:`.codec` — the wire codecs (``cms``/``csk``/``votevec``/``bloom``/
  ``hist``) in the compression registry;
- :mod:`.analyzers` / :mod:`.aggregators` — sketch-domain FA operators
  behind the FSM;
- :mod:`.federation` — the heavy-hitter federation over ``TreeRunner``
  (SecAgg masking, central DP at the root), on a device.
"""
from fedml_tpu_torch.fa.sketch.codec import (
    SKETCH_CODEC_NAMES,
    BloomCodec,
    CountMinCodec,
    CountSketchCodec,
    HistogramCodec,
    VoteVectorCodec,
    sketch_spec_for_task,
)
from fedml_tpu_torch.fa.sketch.sketches import (
    DEFAULT_ALPHABET,
    BloomSketch,
    CountMinSketch,
    CountSketch,
    HistogramSketch,
    VoteVectorSketch,
    k_percentile_from_histogram,
)

__all__ = [
    "SKETCH_CODEC_NAMES",
    "BloomCodec",
    "CountMinCodec",
    "CountSketchCodec",
    "HistogramCodec",
    "VoteVectorCodec",
    "sketch_spec_for_task",
    "DEFAULT_ALPHABET",
    "BloomSketch",
    "CountMinSketch",
    "CountSketch",
    "HistogramSketch",
    "VoteVectorSketch",
    "k_percentile_from_histogram",
]
