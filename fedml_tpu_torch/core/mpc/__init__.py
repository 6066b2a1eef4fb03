"""Finite-field secure-aggregation math — counterpart of
``fedml_tpu/core/mpc``: field quantization (``finite``), Lagrange coded
computing (``lcc``), Shamir sharing and the Bonawitz endpoints
(``secagg``), and LightSecAgg's mask coding (``lightsecagg``). It is host
work in int64/uint64 numpy, as in the reference (torch has too little
uint64 support), with LCC's hot path in a C++ library of the port's own."""
