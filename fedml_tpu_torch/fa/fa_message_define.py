"""FA protocol messages — counterpart of ``fedml_tpu/fa/fa_message_define.py``:
the cross-silo FSM's messages with analytics payloads, string for string."""
from fedml_tpu_torch.cross_silo.message_define import MyMessage


class FAMessage(MyMessage):
    MSG_TYPE_S2C_ANALYZE_REQUEST = "MSG_TYPE_S2C_ANALYZE_REQUEST"
    MSG_TYPE_C2S_SUBMIT = "MSG_TYPE_C2S_SUBMIT"

    MSG_ARG_KEY_FA_TASK = "fa_task"
    MSG_ARG_KEY_SERVER_STATE = "fa_server_state"
    MSG_ARG_KEY_SUBMISSION = "fa_submission"
    MSG_ARG_KEY_RESULT = "fa_result"
    # the round-config header: the sketch spec every client must encode under
    MSG_ARG_KEY_SKETCH_SPEC = "fa_sketch_spec"
