"""Serving runtime of the port: page pool + allocator, sampling, engine,
host page offload, fault tolerance, chaos and the straggler monitor (the
reference's ``repro.runtime`` names)."""
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.fault_tolerance import (FailureInjector, InjectedFailure,
                                                 run_with_restarts)
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector

__all__ = ["StragglerMonitor", "FailureInjector", "InjectedFailure",
           "run_with_restarts", "ChaosConfig", "ChaosInjector",
           "Request", "FinishedRequest", "EngineConfig", "StemEngine",
           "EngineStalledError", "PageAllocator", "PagePool",
           "HostPageStore"]


def __getattr__(name):
    # Lazy: the engine, pool and offload pull in the models and kernels;
    # the light runtime names (straggler / fault tolerance / chaos) stay
    # usable without them.
    if name in ("Request", "FinishedRequest", "EngineConfig", "StemEngine",
                "EngineStalledError"):
        from repro_torch.runtime import engine as _engine
        return getattr(_engine, name)
    if name in ("PageAllocator", "PagePool"):
        from repro_torch.runtime import paged as _paged
        return getattr(_paged, name)
    if name == "HostPageStore":
        from repro_torch.runtime import offload as _offload
        return getattr(_offload, name)
    raise AttributeError(name)
