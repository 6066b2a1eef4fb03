"""Server-side aggregation bookkeeping — counterpart of
``fedml_tpu/cross_silo/server/fedml_aggregator.py``: collect the round's
uploads, check that all (or a quorum) arrived, aggregate, select the next
round's clients and silos, and test the global model.

Uploads are kept as they arrive: an uncompressed model as a port tree on
the server's device, a compressed one as its ``CompressedTree`` (in the
reference's layout). Compressed deltas aggregate through the dequant-fused
sum (``FedMLAggOperator.agg_compressed``) — with a norm-only defense's clip
factors, or as the robust statistic under ``agg_robust`` or a fused defense
— unless a trust-stack hook needs every client's full model
(``compression.requires_full_trees``: a model attack, a list defense,
central DP) or contribution assessment does, in which case each delta is
decoded and the ``ServerAggregator`` hook chain runs. With
``enable_contribution`` the round's client models are valued after the
server step (``core/contribution``; the utility is a coalition
aggregate's test accuracy, v(∅) the round-open global model's). Under
secure aggregation
(:meth:`set_secagg`) every upload must be a masked tree, and the only
reduction is the session's unmask in aggregate.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from fedml_tpu_torch.compression import (
    CompressedTree,
    check_trust_stack,
    get_codec,
    requires_full_trees,
    tree_undelta,
)
from fedml_tpu_torch.core.alg_frame.params import Context
from fedml_tpu_torch.core.alg_frame.server_aggregator import ServerAggregator
from fedml_tpu_torch.core.contribution import ContributionAssessorManager
from fedml_tpu_torch.core.security.defender import FedMLDefender
from fedml_tpu_torch.integrity import resolve_agg_robust
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
from fedml_tpu_torch.ml.aggregator.server_optimizer import ServerOptimizer
from fedml_tpu_torch.models.convert import from_reference_layout, to_reference_layout
from fedml_tpu_torch.simulation.sampling import sample_from_list
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)


class FedMLAggregator:
    def __init__(self, test_global, train_global, all_train_data_num: int,
                 train_data_local_dict: Dict, test_data_local_dict: Dict,
                 train_data_local_num_dict: Dict[int, int], client_num: int,
                 device: Any, args: Any, server_aggregator: ServerAggregator):
        check_trust_stack(args)
        self.aggregator = server_aggregator
        self.args = args
        self.test_global = test_global
        self.all_train_data_num = all_train_data_num
        self.train_data_local_dict = train_data_local_dict
        self.test_data_local_dict = test_data_local_dict
        self.train_data_local_num_dict = train_data_local_num_dict
        self.client_num = int(client_num)
        self.device = device
        self.server_opt = ServerOptimizer(args)
        self._contrib = ContributionAssessorManager(args)
        self.last_contributions: Dict[int, float] = {}
        self.global_params: Optional[Tree] = None
        # under a lossy broadcast codec, the broadcast as the clients decoded
        # it: their deltas resolve against it (None → the exact global)
        self._delta_base: Optional[Tree] = None
        self.model_dict: Dict[int, Any] = {}
        self.sample_num_dict: Dict[int, int] = {}
        self.local_steps_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded_dict = {i: False for i in range(self.client_num)}
        # the secure-aggregation session: masked uploads resolve only in
        # aggregate (privacy/secagg)
        self._secagg = None

    def set_secagg(self, session) -> None:
        self._secagg = session

    def set_global_model_params(self, params: Tree) -> None:
        self.global_params = params

    def set_delta_base(self, params: Optional[Tree]) -> None:
        self._delta_base = params

    def get_upload_base(self) -> Optional[Tree]:
        """The model uploads resolve against: the decoded broadcast under a
        lossy codec, the exact global otherwise."""
        return self._delta_base if self._delta_base is not None else self.global_params

    def get_global_model_params(self) -> Tree:
        return self.global_params

    def add_local_trained_result(self, index: int, model_params: Any, sample_num: int,
                                 local_steps: Optional[float] = None) -> None:
        self.model_dict[index] = model_params
        self.sample_num_dict[index] = int(sample_num)
        if local_steps is not None:
            self.local_steps_dict[index] = float(local_steps)
        self.flag_client_model_uploaded_dict[index] = True

    def check_whether_all_receive(self) -> bool:
        return self.check_whether_all_receive_subset(self.client_num)

    def check_whether_all_receive_subset(self, expected: int) -> bool:
        """All of this round's ``expected`` participants reported?"""
        if len(self.model_dict) < expected:
            return False
        if not all(self.flag_client_model_uploaded_dict.get(i, False)
                   for i in range(expected)):
            return False
        for i in range(expected):
            self.flag_client_model_uploaded_dict[i] = False
        return True

    def n_received(self) -> int:
        """Uploads staged for the current round (the quorum count)."""
        return len(self.model_dict)

    def drop_client_upload(self, index: int) -> None:
        """Remove one staged upload (a screened one, or in secagg recovery a
        survivor that never revealed: its masks can no longer be removed)."""
        self.model_dict.pop(index, None)
        self.sample_num_dict.pop(index, None)
        self.local_steps_dict.pop(index, None)
        self.flag_client_model_uploaded_dict[index] = False

    def close_round_quorum(self, expected: int) -> List[int]:
        """Close a round on quorum: reset the upload flags and return the
        cohort positions that never reported. ``aggregate()`` then reduces
        the received subset, whose sample weights renormalize over itself."""
        missing = [i for i in range(expected)
                   if not self.flag_client_model_uploaded_dict.get(i, False)]
        for i in range(expected):
            self.flag_client_model_uploaded_dict[i] = False
        return missing

    def _resolve_compressed(self, raw_list: List[Tuple[int, Any]]
                            ) -> Tuple[List[Tuple[int, Any]], Optional[Tree]]:
        """Compressed uploads: all delta-encoded and no hook needing full
        models → the dequant-fused sum (no per-client f32 tree is built),
        returned as ``w_agg``; otherwise each is decoded back to a full port
        tree for the hook chain. A masked round has one legal reduction, the
        unmask (the manager validated each upload on receipt)."""
        if self._secagg is not None:
            bad = [m for _, m in raw_list if not (
                isinstance(m, CompressedTree) and getattr(get_codec(m.codec), "maskable",
                                                          False))]
            if bad:
                raise ValueError(f"unmasked upload(s) reached a secagg aggregate: "
                                 f"{[type(m).__name__ for m in bad]}")
            return raw_list, from_reference_layout(self._secagg.aggregate(
                [m for _, m in raw_list], to_reference_layout(self.get_upload_base())))
        if not any(isinstance(m, CompressedTree) for _, m in raw_list):
            return raw_list, None
        base = self.get_upload_base()
        codec = next(get_codec(m.codec) for _, m in raw_list
                     if isinstance(m, CompressedTree))
        if all(isinstance(m, CompressedTree) and m.is_delta for _, m in raw_list) \
                and not (requires_full_trees(codec, self.args)
                         or self._contrib.is_enabled()):
            agg_robust = resolve_agg_robust(self.args, codec=codec)
            clip = None if agg_robust else FedMLDefender.get_instance(
                ).fused_clip_factors([m for _, m in raw_list])
            return raw_list, from_reference_layout(FedMLAggOperator.agg_compressed(
                self.args, raw_list, to_reference_layout(base), clip_factors=clip,
                agg_robust=agg_robust))
        decoded = []
        for n, m in raw_list:
            if isinstance(m, CompressedTree):
                tree = from_reference_layout(get_codec(m.codec).decode(m))
                m = tree_undelta(base, tree) if m.is_delta else tree
            decoded.append((n, m))
        return decoded, None

    def aggregate(self) -> Tree:
        # sorted by cohort position: the order threads delivered the uploads
        # in cannot change the sum
        order = sorted(self.model_dict)
        raw_list = [(self.sample_num_dict[i], self.model_dict[i]) for i in order]
        Context().add("global_model_for_defense", self.global_params)
        raw_list, w_agg = self._resolve_compressed(raw_list)
        if w_agg is None:
            w_list, _ = self.aggregator.on_before_aggregation(raw_list)
            w_agg = self.aggregator.aggregate(w_list)
            w_agg = self.aggregator.on_after_aggregation(w_agg)
        tau_eff = None
        if (str(getattr(self.args, "federated_optimizer", "")) == "FedNova"
                and self.local_steps_dict):
            counts = np.asarray([float(self.sample_num_dict[i]) for i in order])
            taus = np.asarray([self.local_steps_dict.get(i, 1.0) for i in order])
            tau_eff = float(np.sum(counts / counts.sum() * taus))
        prev_global = self.global_params
        self.global_params = self.server_opt.step(self.global_params, w_agg,
                                                  tau_eff=tau_eff)
        if self._contrib.is_enabled():
            def util(params):
                return self.aggregator.test(params, self.test_global, self.device,
                                            self.args).get("test_acc", 0.0)

            self.last_contributions = self._contrib.run(
                order, raw_list, util, util(prev_global),
                int(getattr(self.args, "round_idx", 0)))
        self.model_dict.clear()
        self.sample_num_dict.clear()
        self.local_steps_dict.clear()
        return self.global_params

    # -- selection: the shared seeded draw, so every backend (and the
    # reference) selects the same clients and silos
    def data_silo_selection(self, round_idx: int, client_num_in_total: int,
                            client_num_per_round: int) -> List[int]:
        return sample_from_list(list(range(client_num_in_total)), client_num_per_round,
                                round_idx, int(getattr(self.args, "random_seed", 0)))

    def client_selection(self, round_idx: int, client_id_list_in_total: List[int],
                         client_num_per_round: int) -> List[int]:
        return sample_from_list(list(client_id_list_in_total), client_num_per_round,
                                round_idx, int(getattr(self.args, "random_seed", 0)))

    def test_on_server_for_all_clients(self, round_idx: int) -> dict:
        metrics = self.aggregator.test(self.global_params, self.test_global,
                                       self.device, self.args)
        logger.info("server test round %d: %s", round_idx, metrics)
        return metrics
