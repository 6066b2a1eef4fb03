"""In-process FA federation — counterpart of ``fedml_tpu/fa/run_inproc.py``:
``run_fa_inproc(args, client_data)`` drives the manager FSMs over the
deterministic LOCAL transport on one device and returns the server's result.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.fa.aggregator import create_aggregator
from fedml_tpu_torch.fa.analyzer import create_analyzer
from fedml_tpu_torch.fa.fa_client_manager import FAClientManager
from fedml_tpu_torch.fa.fa_message_define import FAMessage
from fedml_tpu_torch.fa.fa_server_manager import FAServerManager


def run_fa_inproc(args: Any, client_data: Dict[int, Any], timeout: float = 120.0,
                  device: DeviceLike = "cuda") -> Optional[dict]:
    """client_data: {rank (1-based): list/array of local values}; the
    sketches are encoded and merged on ``device``."""
    device = resolve_device(device)
    run_id = str(getattr(args, "run_id", "fa"))
    LocalBroker.destroy(run_id)
    client_num = len(client_data)
    task = str(getattr(args, "fa_task"))

    server_mgr = FAServerManager(
        args, create_aggregator(task, args, device), client_rank=0, client_num=client_num)
    client_mgrs: List[FAClientManager] = []
    for rank in sorted(client_data):
        cargs = copy.copy(args)
        cargs.rank = rank
        client_mgrs.append(FAClientManager(
            cargs, create_analyzer(task, cargs, device), client_data[rank],
            rank=rank, size=client_num + 1))
    managers = [server_mgr] + client_mgrs
    return run_managers_to_completion(
        managers, run_id, FAMessage.MSG_TYPE_CONNECTION_IS_READY, timeout)
