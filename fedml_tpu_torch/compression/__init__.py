"""Compression of the port: for now the NF4 codebook the 4-bit weight
format shares with the wire codecs (``codecs.py``)."""
from fedml_tpu_torch.compression.codecs import NF4_CODEBOOK

__all__ = ["NF4_CODEBOOK"]
