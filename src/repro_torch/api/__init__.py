"""Public plan -> engine API: explore offline, save the plan, serve it.

    from repro_torch.api import CompressionPlan, InferenceEngine
"""
from repro_torch.api.plan import CompressionPlan, LayerPlan, merge_plans
from repro_torch.api.engine import (GenerationResult, InferenceEngine,
                                    SamplingParams, ServeResult, TokenEvent)
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculation import DraftSpec

__all__ = [
    "CompressionPlan", "LayerPlan", "merge_plans",
    "GenerationResult", "InferenceEngine", "SamplingParams",
    "ServeResult", "TokenEvent", "Request", "DraftSpec",
]
