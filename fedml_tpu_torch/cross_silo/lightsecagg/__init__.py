"""LightSecAgg cross-silo engine — counterpart of
``fedml_tpu/cross_silo/lightsecagg``."""
from fedml_tpu_torch.cross_silo.lightsecagg.run_inproc import (  # noqa: F401
    run_lightsecagg_inproc,
)
