from anorag_tpu_torch.llm.clients import LMStudioClient, OllamaClient, OpenAIClient
from anorag_tpu_torch.llm.factory import LLMFactory
from anorag_tpu_torch.llm.local_llm import LocalLLM
from anorag_tpu_torch.llm.multi_model import HybridLLMDispatcher, MultiModelClient, TaskClassifier
from anorag_tpu_torch.llm.note_generator import AtomicNoteGenerator

__all__ = ["LMStudioClient", "OllamaClient", "OpenAIClient", "LLMFactory",
           "LocalLLM", "HybridLLMDispatcher", "MultiModelClient",
           "TaskClassifier", "AtomicNoteGenerator"]
