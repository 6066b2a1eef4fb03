"""LightSecAgg protocol messages — counterpart of
``fedml_tpu/cross_silo/lightsecagg/lsa_message_define.py``: the encoded-mask
exchange (client → server → client) and the one-shot aggregate-encoded-mask
round."""
from fedml_tpu_torch.cross_silo.message_define import MyMessage


class LSAMessage(MyMessage):
    # client → server
    MSG_TYPE_C2S_SEND_ENCODED_MASK = "MSG_TYPE_C2S_SEND_ENCODED_MASK"
    MSG_TYPE_C2S_SEND_MASKED_MODEL = "MSG_TYPE_C2S_SEND_MASKED_MODEL"
    MSG_TYPE_C2S_SEND_AGG_MASK = "MSG_TYPE_C2S_SEND_AGG_MASK"
    # server → client
    MSG_TYPE_S2C_FORWARD_ENCODED_MASK = "MSG_TYPE_S2C_FORWARD_ENCODED_MASK"
    MSG_TYPE_S2C_REQUEST_AGG_MASK = "MSG_TYPE_S2C_REQUEST_AGG_MASK"

    MSG_ARG_KEY_ENCODED_MASK = "encoded_mask"
    MSG_ARG_KEY_MASK_TARGET = "mask_target_client"
    MSG_ARG_KEY_ACTIVE_CLIENTS = "active_clients"
    MSG_ARG_KEY_AGG_ENCODED_MASK = "agg_encoded_mask"
    MSG_ARG_KEY_MASKED_MODEL = "masked_model"
