"""Bonawitz SecAgg protocol messages — counterpart of
``fedml_tpu/cross_silo/secagg/sa_message_define.py``, string for string:
the public-key advertisement and broadcast, the Shamir seed-share relay
(client → server → client), the masked upload, and the reconstruction
round that reveals the survivors' self-seed shares and the dropped
clients' pairwise seeds."""
from fedml_tpu_torch.cross_silo.message_define import MyMessage


class SAMessage(MyMessage):
    # client → server
    MSG_TYPE_C2S_SEND_PUBLIC_KEY = "MSG_TYPE_C2S_SEND_PUBLIC_KEY"
    MSG_TYPE_C2S_SEND_SEED_SHARE = "MSG_TYPE_C2S_SEND_SEED_SHARE"
    MSG_TYPE_C2S_SEND_MASKED_MODEL = "MSG_TYPE_C2S_SEND_MASKED_MODEL"
    MSG_TYPE_C2S_SEND_RECONSTRUCTION = "MSG_TYPE_C2S_SEND_RECONSTRUCTION"
    MSG_TYPE_C2S_DROPOUT = "MSG_TYPE_C2S_DROPOUT"  # stands in for a timeout
    # server → client
    MSG_TYPE_S2C_BROADCAST_PUBLIC_KEYS = "MSG_TYPE_S2C_BROADCAST_PUBLIC_KEYS"
    MSG_TYPE_S2C_FORWARD_SEED_SHARE = "MSG_TYPE_S2C_FORWARD_SEED_SHARE"
    MSG_TYPE_S2C_REQUEST_RECONSTRUCTION = "MSG_TYPE_S2C_REQUEST_RECONSTRUCTION"

    MSG_ARG_KEY_PUBLIC_KEY = "public_key"
    MSG_ARG_KEY_PUBLIC_KEYS = "public_keys"
    MSG_ARG_KEY_SHARE_TARGET = "share_target_client"
    MSG_ARG_KEY_SEED_SHARE = "seed_share"
    MSG_ARG_KEY_MASKED_MODEL = "masked_model"
    MSG_ARG_KEY_SURVIVORS = "survivors"
    MSG_ARG_KEY_DROPPED = "dropped"
    MSG_ARG_KEY_SELF_SHARES = "revealed_self_shares"
    MSG_ARG_KEY_PAIRWISE_SEEDS = "revealed_pairwise_seeds"
