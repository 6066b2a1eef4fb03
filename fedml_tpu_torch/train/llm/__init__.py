"""Federated LoRA fine-tuning of Llama models — counterpart of
``fedml_tpu/train/llm``: the trainer and its fused round
(``trainer.py``), the client/aggregator pair (``federated.py``) and the
round loop (``run_fedllm.py``)."""
