"""ray_tpu_torch.llm — in-process LLM engines (PyTorch port of
ray_tpu.llm).

- ``LLMConfig`` — model + generation + deployment settings
- ``LLMEngine`` — in-process generator (tokenize → generate → detokenize)
- ``ContinuousLLMEngine`` — the same over a continuous batcher

``build_llm_processor`` and ``serve_llm`` wait for the Data and Serve
ports.
"""

from ray_tpu_torch.llm.config import ByteTokenizer, LLMConfig
from ray_tpu_torch.llm.engine import ContinuousLLMEngine, LLMEngine
from ray_tpu_torch.models.decoding import Generator, SamplingParams

__all__ = [
    "ByteTokenizer",
    "ContinuousLLMEngine",
    "Generator",
    "LLMConfig",
    "LLMEngine",
    "SamplingParams",
]
