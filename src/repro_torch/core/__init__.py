from ..device import resolve_device
from .chain_router import ChainRouter, GenerationResult, RouterSession
from .executor import Executor
from .model_pool import ModelPool, PoolEntry
from .profiler import EMA, PerformanceProfiler
from .scheduler import ChainChoice, ModelChainScheduler
from .similarity import SimilarityStore
from .state_manager import StateManager
from . import verification

__all__ = ["ChainRouter", "GenerationResult", "RouterSession", "Executor",
           "ModelPool", "PoolEntry", "resolve_device", "EMA",
           "PerformanceProfiler", "ChainChoice", "ModelChainScheduler",
           "SimilarityStore", "StateManager", "verification"]
