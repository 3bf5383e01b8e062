from repro_torch.serving.api import LLM, RequestHandle
from repro_torch.serving.disagg import DisaggRouter, KVTransfer
from repro_torch.serving.engine import EngineCfg, Request, ServingEngine
from repro_torch.serving.engine_core import Backend, EngineCore
from repro_torch.serving.faults import FaultInjected, FaultPlan, FaultyBackend
from repro_torch.serving.paged import (PagedBackend, PagedEngineCfg,
                                       PagedServingEngine)
from repro_torch.serving.scheduler import (AdmissionCfg, BudgetController,
                                           ExecFault, NeedPages, Scheduler,
                                           SchedulerCfg)
from repro_torch.serving.swap_policy import RetryGovernor

__all__ = ["AdmissionCfg", "Backend", "BudgetController", "DisaggRouter",
           "EngineCfg", "EngineCore", "ExecFault", "FaultInjected",
           "FaultPlan", "FaultyBackend", "KVTransfer", "LLM", "NeedPages",
           "PagedBackend", "PagedEngineCfg", "PagedServingEngine",
           "Request", "RequestHandle", "RetryGovernor", "Scheduler",
           "SchedulerCfg", "ServingEngine"]
