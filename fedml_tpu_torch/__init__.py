"""fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu for NVIDIA Hopper.

The JAX package ``fedml_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find, imports neither JAX nor
anything of ``fedml_tpu``, and replaces every Pallas kernel on a ported
path with a CUDA kernel written for ``sm_90a`` (``ops/csrc``).

Ported so far: the int8 serving path (``models.llm.llama``,
``ops.quant``, ``serving``) and federated LoRA fine-tuning with the
on-device round (``train.llm``, ``ops.flash_attention``, ``data``,
``simulation.sampling``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
from fedml_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
