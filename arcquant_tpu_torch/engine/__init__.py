"""Single-device serving engine over the paged int4 KV cache, sampling,
and a continuous-batching scheduler (the HTTP front is ``.server``)."""

from .engine import EngineConfig, InferenceEngine
from .sampling import SamplingParams, sample
from .scheduler import ContinuousBatcher, PageAllocator, Request
from .spec import EngineDrafter, NgramDrafter, SpeculativeEngine
