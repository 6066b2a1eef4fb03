"""Supervised kill-and-respawn of the cross-silo server — counterpart of
``fedml_tpu/resilience/durability/recover.py``.

The runner spawns a cross-silo federation as OS processes over the port's
broker, SIGKILLs the server mid-round (the
:class:`~fedml_tpu_torch.resilience.chaos.ServerKillWindow` fires inside
the server once it has journaled ``after_uploads`` uploads), respawns it
with ``resume: true`` and supervises to completion, measuring:

- **MTTR** — seconds from the observed death to the respawned server
  announcing its journal replay (the ``RESUMED`` marker);
- **salvaged uploads** — journaled uploads that re-entered the aggregator
  with no client retraining them (each client prints ``TRAINED <round>``
  per local round, so a retrain shows);
- **bit-identity** — the final parameters' digest, to hold against an
  uninterrupted run of the same seed (identity codec: equal).

Every rank, and the respawned server, gets one ``PYTHONHASHSEED`` (the
CIFAR stand-in's seed goes through ``hash``). The config names the ranks'
device (``common_args.device``, ``"cuda"`` unless the caller says
``"cpu"``); on the card the ranks hold cuDNN to its deterministic
algorithms, which bit-identical resume needs.

This module is also the per-rank entry point::

    python -m fedml_tpu_torch.resilience.durability.recover \\
        --cf cfg.json --rank 0 --role server
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

__all__ = ["run_recover_scenario", "scenario_config", "supervise_federation"]


def digest(params: Any) -> str:
    """blake2b-128 over a port tree's leaves, in the reference's layout and
    leaf order, as contiguous host bytes."""
    import numpy as np

    from fedml_tpu_torch.models.convert import to_reference_layout
    from fedml_tpu_torch.utils.tree import leaf_order

    ref = to_reference_layout(params)
    h = hashlib.blake2b(digest_size=16)
    for path in leaf_order(ref):
        h.update(np.ascontiguousarray(ref[path].detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def scenario_config(run_id: str, seed: int, rounds: int, clients: int, broker_host: str,
                    broker_port: int, tmp: str, compression: str = "identity",
                    extra_train: Optional[Dict] = None, device: str = "cuda") -> Dict:
    """The one federation config the supervisor and the ranks share (the
    reference's LR on its synthetic data)."""
    return {
        "common_args": {"training_type": "cross_silo", "random_seed": seed,
                        "run_id": run_id, "log_file_dir": os.path.join(tmp, "logs"),
                        "device": device},
        "data_args": {"dataset": "synthetic", "train_size": 80 * clients,
                      "test_size": 40, "class_num": 4, "feature_dim": 10},
        "model_args": {"model": "lr"},
        "train_args": {
            "federated_optimizer": "FedAvg", "comm_backend": "BROKER",
            "broker_host": broker_host, "broker_port": broker_port,
            "object_store_dir": os.path.join(tmp, "store"),
            "client_num_in_total": clients, "client_num_per_round": clients,
            "comm_round": rounds, "epochs": 1, "batch_size": 16, "learning_rate": 0.3,
            "durability": True, "resume": True,
            "checkpoint_dir": os.path.join(tmp, "ckpts"),
            **({"compression": compression} if compression else {}),
            **(extra_train or {}),
        },
    }


# -- the per-rank entry point --------------------------------------------------

def _rank_main(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cf", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--role", choices=("server", "client"), required=True)
    ns = ap.parse_args(argv)

    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.telemetry import get_registry

    with open(ns.cf) as f:
        cfg = json.load(f)
    args = load_arguments_from_dict(cfg)
    args.rank = ns.rank
    dev = resolve_device(getattr(args, "device", "cuda"))
    if dev.type == "cuda":
        # a respawned server resumes bit for bit only on deterministic kernels
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    args = fedml_tpu_torch.init(args)
    ds = load_federated(args)
    model = create(args, ds.class_num)

    if ns.role == "server":
        from fedml_tpu_torch.cross_silo.server.server import Server

        server = Server(args, dev, ds, model)
        mgr = server.manager
        sal = getattr(mgr, "_salvaged", None)
        if sal is not None:
            # the supervisor's MTTR clock stops here: the respawned server
            # holds its salvaged round and is accepting uploads
            print("RESUMED " + json.dumps({  # noqa: T201 (rank protocol)
                "round": sal.round_idx, "salvaged": len(sal.uploads),
                "clients": sorted(sal.uploaded_clients)}), flush=True)
        result = server.run()
        reg = get_registry()
        print("METRICS " + json.dumps({  # noqa: T201 (rank protocol)
            m.name: m.snapshot() for m in reg._items()
            if m.name.startswith("resilience/journal")}), flush=True)
        print("DIGEST " + digest(mgr.aggregator.get_global_model_params()),  # noqa: T201
              flush=True)
        print("RESULT " + json.dumps(result, default=str), flush=True)  # noqa: T201
        return 0

    from fedml_tpu_torch.cross_silo.client.client import Client

    client = Client(args, dev, ds, model)
    adapter = client.manager.trainer_dist_adapter
    orig_train = adapter.train

    def train(round_idx, weights):
        # a salvaged client must never train its journaled round twice
        print(f"TRAINED {int(round_idx)}", flush=True)  # noqa: T201 (rank protocol)
        return orig_train(round_idx, weights)

    adapter.train = train
    client.run()
    print("CLIENT DONE", flush=True)  # noqa: T201 (rank protocol)
    return 0


# -- the supervisor -------------------------------------------------------------

class _Pump(threading.Thread):
    """A child's stdout as timestamped lines."""

    def __init__(self, proc: subprocess.Popen, name: str):
        super().__init__(name=f"pump-{name}", daemon=True)
        self.proc = proc
        self.lines: List[tuple] = []  # (ts, line)
        self.start()

    def run(self) -> None:
        for raw in self.proc.stdout:
            self.lines.append((time.time(), raw.rstrip("\n")))

    def find(self, prefix: str) -> Optional[tuple]:
        for ts, line in self.lines:
            if line.startswith(prefix):
                return ts, line
        return None


def _spawn(role: str, rank: int, cfg_path: str, env: Dict[str, str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "fedml_tpu_torch.resilience.durability.recover",
         "--cf", cfg_path, "--rank", str(rank), "--role", role],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def supervise_federation(cfg: Dict, work: str, kill: Optional[Dict] = None,
                         max_restarts: int = 2, restart_backoff_s: float = 0.25,
                         timeout: float = 600.0, hashseed: str = "0") -> Dict:
    """Run the federation ``cfg`` describes as a server and
    ``client_num_per_round`` client processes, the server supervised: any
    abnormal exit (the chaos SIGKILL, an OOM, an exception) goes through a
    :class:`~fedml_tpu_torch.scheduler.supervision.RestartTracker`, and a
    restart respawns the server, which resumes from its journal. ``kill``
    (``{"round": r, "after_uploads": n}``) arms the kill window in the first
    server process only. Every process gets ``PYTHONHASHSEED=hashseed``.
    Returns the summary (see :func:`run_recover_scenario`) with each
    client's ``TRAINED`` markers and their times."""
    from fedml_tpu_torch.scheduler.supervision import (
        RestartPolicy,
        RestartTracker,
        describe_rc,
    )
    from fedml_tpu_torch.telemetry import get_registry

    clients = int(cfg["train_args"]["client_num_per_round"])
    run_id = str(cfg["common_args"]["run_id"])
    os.makedirs(work, exist_ok=True)
    cfg_path = os.path.join(work, f"{run_id}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, PYTHONHASHSEED=str(hashseed))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.pop("FEDML_CHAOS_KILL_SERVER", None)
    t0 = time.time()
    restarts = 0
    mttr_s = None
    resumed: Dict = {}
    server_pumps: List[_Pump] = []
    client_procs: List[subprocess.Popen] = []
    client_pumps: List[_Pump] = []
    try:
        for r in range(1, clients + 1):
            p = _spawn("client", r, cfg_path, env)
            client_procs.append(p)
            client_pumps.append(_Pump(p, f"client{r}"))
        tracker = RestartTracker(RestartPolicy(
            max_restarts=max_restarts, backoff_s=restart_backoff_s,
            crash_loop_threshold=3, fast_fail_s=10.0, resume=True))
        give_up_reason = None
        # the kill spec rides an environment variable of the first server
        # process only: the respawn must not re-trigger its own death
        first_env = dict(env, FEDML_CHAOS_KILL_SERVER=json.dumps(kill)) if kill else env
        server = _spawn("server", 0, cfg_path, first_env)
        pump = _Pump(server, "server")
        server_pumps.append(pump)
        spawned_at = time.time()
        t_kill = None
        deadline = time.time() + timeout
        while True:
            rc = server.poll()
            if rc is None:
                if time.time() > deadline:
                    raise TimeoutError(f"the supervised federation did not finish in "
                                       f"{timeout}s")
                time.sleep(0.05)
                continue
            if rc == 0:
                break
            action, detail = tracker.on_exit(rc, time.time() - spawned_at)
            if action != "restart":
                give_up_reason = detail
                break
            if t_kill is None:
                t_kill = time.time()
            restarts += 1
            get_registry().counter("resilience/restarts").inc()
            time.sleep(detail)  # the deterministic backoff
            server = _spawn("server", 0, cfg_path, env)
            pump = _Pump(server, "server")
            server_pumps.append(pump)
            spawned_at = time.time()
        # the pump may still be draining the pipe: join before reading
        pump.join(timeout=30)
        if server.returncode != 0:
            tail = "\n".join(line for _, line in pump.lines[-30:])
            raise RuntimeError(f"server exited {describe_rc(server.returncode)}"
                               + (f" ({give_up_reason})" if give_up_reason else "")
                               + f":\n{tail}")
        hit = pump.find("RESUMED ")
        if hit is not None:
            ts, line = hit
            resumed = json.loads(line[len("RESUMED "):])
            if t_kill is not None:
                mttr_s = ts - t_kill
        digest_line = pump.find("DIGEST ")
        result_line = pump.find("RESULT ")
        metrics_line = pump.find("METRICS ")
        for p in client_procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
        for cp in client_pumps:
            cp.join(timeout=30)  # drain the TRAINED markers before counting
        trained: Dict[str, List[int]] = {}
        trained_at: Dict[str, List[float]] = {}
        for r, cp in enumerate(client_pumps, start=1):
            marks = [(ts, int(line.split()[1])) for ts, line in cp.lines
                     if line.startswith("TRAINED ")]
            trained[str(r)] = [m for _, m in marks]
            trained_at[str(r)] = [ts - t0 for ts, _ in marks]
        return {
            "completed": result_line is not None,
            "restarts": restarts,
            "mttr_s": round(mttr_s, 3) if mttr_s is not None else None,
            "killed_at_s": round(t_kill - t0, 3) if t_kill is not None else None,
            "salvaged_uploads": int(resumed.get("salvaged", 0)),
            "salvaged_clients": resumed.get("clients", []),
            "resumed_round": resumed.get("round"),
            "digest": digest_line[1][len("DIGEST "):] if digest_line else None,
            "result": (json.loads(result_line[1][len("RESULT "):])
                       if result_line else None),
            "server_metrics": (json.loads(metrics_line[1][len("METRICS "):])
                               if metrics_line else None),
            "trained": trained,
            "trained_at_s": trained_at,
            "wall_s": round(time.time() - t0, 3),
        }
    finally:
        for p in client_procs + [sp.proc for sp in server_pumps]:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_recover_scenario(seed: int = 0, rounds: int = 5, clients: int = 2,
                         kill_round: int = 2, after_uploads: int = 1,
                         compression: str = "identity", kill: bool = True,
                         max_restarts: int = 2, restart_backoff_s: float = 0.25,
                         timeout: float = 600.0, tmp_dir: Optional[str] = None,
                         extra_train: Optional[Dict] = None,
                         device: str = "cuda") -> Dict:
    """One supervised federation over a broker this starts; returns a
    JSON-safe summary: ``completed``, ``restarts``, ``mttr_s``,
    ``salvaged_uploads``, ``salvaged_clients``, ``resumed_round``,
    ``digest``, ``result``, ``trained`` (each client's trained rounds) and
    ``wall_s``. ``kill=False`` is the uninterrupted run of the same seed,
    whose digest a killed identity-codec run must equal."""
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
    from fedml_tpu_torch.device import resolve_device

    resolve_device(device)  # refuse a missing card before any process starts
    tmp = tmp_dir or tempfile.mkdtemp(prefix="fedml_recover_")
    broker = PubSubBroker("127.0.0.1", 0).start()
    try:
        host, port = broker.address
        run_id = f"recover_{seed}_{'kill' if kill else 'base'}"
        cfg = scenario_config(run_id, seed, rounds, clients, host, port, tmp, compression,
                              extra_train=extra_train, device=device)
        out = supervise_federation(
            cfg, tmp, kill={"round": int(kill_round), "after_uploads": int(after_uploads)}
            if kill else None, max_restarts=max_restarts,
            restart_backoff_s=restart_backoff_s, timeout=timeout)
    finally:
        broker.stop()
        if tmp_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    out.pop("trained_at_s")
    out.pop("server_metrics")
    return {"seed": int(seed), "rounds": int(rounds), "clients": int(clients),
            "kill": bool(kill), "compression": compression, **out}


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
