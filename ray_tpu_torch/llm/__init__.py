"""ray_tpu_torch.llm — LLM engines, batch inference and serving (PyTorch
port of ray_tpu.llm).

- ``LLMConfig`` — model + generation + deployment settings
- ``LLMEngine`` — in-process generator (tokenize → generate → detokenize)
- ``ContinuousLLMEngine`` — the same over a continuous batcher
- ``build_llm_processor`` — batch inference over ray_tpu_torch.data
  Datasets
- ``build_llm_deployment`` / ``serve_llm`` — a Serve deployment with
  continuous or @serve.batch batching and streaming text responses, its
  replica's engine on the card it leases
"""

from ray_tpu_torch.llm.config import ByteTokenizer, LLMConfig
from ray_tpu_torch.llm.engine import ContinuousLLMEngine, LLMEngine
from ray_tpu_torch.llm.batch import build_llm_processor
from ray_tpu_torch.llm.serving import build_llm_deployment, serve_llm
from ray_tpu_torch.models.decoding import Generator, SamplingParams

__all__ = [
    "ByteTokenizer",
    "ContinuousLLMEngine",
    "Generator",
    "LLMConfig",
    "LLMEngine",
    "SamplingParams",
    "build_llm_deployment",
    "build_llm_processor",
    "serve_llm",
]
