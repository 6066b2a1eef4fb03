"""LlamaPredictor — binds the continuous-batching engine to the serving
contract (counterpart of ``fedml_tpu/serving/llm_predictor.py``).

Request body::

  {"prompt_tokens": [int, ...], "max_new_tokens": 32,
   "temperature": 0.0, "seed": 0, "eos_id": null, "stream": false}

Response: ``{"tokens": [...]}`` — or, when ``stream`` is true, an iterator
of ``{"token": t}`` chunks followed by ``{"done": true}``. Tokenization is
the caller's.
"""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.serving.llm_engine import ContinuousBatchingEngine
from fedml_tpu_torch.serving.predictor import FedMLPredictor


class LlamaPredictor(FedMLPredictor):
    def __init__(self, engine: ContinuousBatchingEngine):
        self.engine = engine
        engine.start()

    def ready(self) -> bool:
        return self.engine._thread is not None and self.engine._thread.is_alive()

    def predict(self, request: Any) -> Any:
        prompt = list(map(int, request.get("prompt_tokens", [])))
        if not prompt:
            raise ValueError("prompt_tokens is required and must be non-empty")
        max_new = int(request.get("max_new_tokens", 32))
        temperature = float(request.get("temperature", 0.0))
        seed = int(request.get("seed", 0))
        eos = request.get("eos_id")
        eos = None if eos is None else int(eos)
        if request.get("stream"):
            q = self.engine.submit(prompt, max_new, temperature, seed, eos)

            def stream():
                while True:
                    tok = q.get()
                    if tok is None:
                        if q.error is not None:
                            raise RuntimeError("serving engine failed") from q.error
                        yield {"done": True}
                        return
                    yield {"token": tok}

            return stream()
        toks = self.engine.generate(prompt, max_new, temperature, seed, eos)
        return {"tokens": toks}
