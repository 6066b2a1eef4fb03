"""Bonawitz secure-aggregation cross-silo engine — counterpart of
``fedml_tpu/cross_silo/secagg``: the server and client FSMs over the
finite-field math of ``core/mpc/secagg.py``, selected by
``secure_aggregation: true``. ``run_secagg_inproc`` loads on first use (it
needs the server and client facades, which import this package)."""
from fedml_tpu_torch.cross_silo.secagg.sa_client_manager import SAClientManager
from fedml_tpu_torch.cross_silo.secagg.sa_message_define import SAMessage
from fedml_tpu_torch.cross_silo.secagg.sa_server_manager import SAServerManager

__all__ = ["SAClientManager", "SAMessage", "SAServerManager", "run_secagg_inproc"]


def __getattr__(name):
    if name == "run_secagg_inproc":
        from fedml_tpu_torch.cross_silo.secagg.run_inproc import run_secagg_inproc

        return run_secagg_inproc
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
