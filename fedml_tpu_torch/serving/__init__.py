"""Serving of the port: continuous-batching LLM engine, predictor and the
HTTP runner (counterparts of ``fedml_tpu/serving``)."""
from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner
from fedml_tpu_torch.serving.llm_engine import ContinuousBatchingEngine
from fedml_tpu_torch.serving.llm_predictor import LlamaPredictor
from fedml_tpu_torch.serving.monitor import EndpointMonitor, ServingSLO
from fedml_tpu_torch.serving.predictor import FedMLPredictor

__all__ = [
    "ContinuousBatchingEngine",
    "EndpointMonitor",
    "FedMLInferenceRunner",
    "FedMLPredictor",
    "LlamaPredictor",
    "ServingSLO",
]
