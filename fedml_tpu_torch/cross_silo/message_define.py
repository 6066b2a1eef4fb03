"""Cross-silo message types and keys — counterpart of
``fedml_tpu/cross_silo/message_define.py``, string for string."""


class MyMessage:
    # server → client
    MSG_TYPE_S2C_INIT_CONFIG = "MSG_TYPE_S2C_INIT_CONFIG"
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = "MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT"
    MSG_TYPE_S2C_FINISH = "MSG_TYPE_S2C_FINISH"
    MSG_TYPE_S2C_CHECK_CLIENT_STATUS = "MSG_TYPE_S2C_CHECK_CLIENT_STATUS"
    # re-sync an evicted client that reconnected: current round and model,
    # no training; it re-enters the cohort at the next selection
    MSG_TYPE_S2C_REJOIN_SYNC = "MSG_TYPE_S2C_REJOIN_SYNC"

    # client → server
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = "MSG_TYPE_C2S_SEND_MODEL_TO_SERVER"
    MSG_TYPE_C2S_CLIENT_STATUS = "MSG_TYPE_C2S_CLIENT_STATUS"

    MSG_TYPE_CONNECTION_IS_READY = "MSG_TYPE_CONNECTION_IS_READY"

    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_CLIENT_OS = "client_os"
    MSG_ARG_KEY_ROUND = "round"

    MSG_CLIENT_STATUS_OFFLINE = "OFFLINE"
    MSG_CLIENT_STATUS_IDLE = "IDLE"
