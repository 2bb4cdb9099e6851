"""The port's core: fabric and schedule builders, CC policies (the
learned ``mlp`` among them), the fluid engine with its fault layer and
its differentiable soft cost, gradient autotuning, scenario specs, the
sweep runner (single runs, batched lanes, grids, the policy axis) with
its backend calibration, resilient campaigns, the DLRM iteration
workload and the HLO-replay prediction bridge."""
from repro_torch.core.autotune import (TuneResult, autotune,  # noqa: F401
                                       autotune_spec)
from repro_torch.core.campaign import (CampaignError,  # noqa: F401
                                       CampaignFingerprintMismatch,
                                       CampaignResult, CampaignTask,
                                       run_campaign, smoke_tasks)
from repro_torch.core.cc import (ALL_POLICIES, REGISTRY, FlowCtx,  # noqa: F401
                                 ParamSpec, Policy, Signals, get_policy,
                                 kernel_param_keys, kernel_state_keys,
                                 make_dcqcn, make_dctcp, make_hpcc,
                                 make_hpcc_pint, make_pfc_only,
                                 make_static_window, make_timely,
                                 pack_params, pack_state, stack_labels,
                                 stack_policies, unpack_state)
from repro_torch.core.collectives import (COLLECTIVES,  # noqa: F401
                                          Schedule, ScheduleBuilder,
                                          allreduce_1d, allreduce_2d,
                                          allreduce_hring, allreduce_ring,
                                          alltoall, get_collective, incast)
from repro_torch.core.engine import (FABRIC_PARAM_SPECS,  # noqa: F401
                                     EngineConfig, FabricParams,
                                     Results, Simulator, resolve_step_impl,
                                     simulate)
from repro_torch.core.faults import (FAULT_PARAM_SPECS,  # noqa: F401
                                     RECOVERY_MODES, FaultSpec, LaneStatus,
                                     classify_lane, is_faulty)
from repro_torch.core.scenario import (CollectiveSpec,  # noqa: F401
                                       FabricSpec, IncastSpec, ScenarioSpec,
                                       TOPOLOGIES, register_topology,
                                       scenario_matrix)
from repro_torch.core.sweep import (BackendCalibration,  # noqa: F401
                                    BatchResults, SweepRunner,
                                    calibrate_backend, get_calibration,
                                    grid_from_spec, load_calibration,
                                    reset_unhealthy_warnings,
                                    save_calibration, stack_policy_axis)
from repro_torch.core.topology import (LINK_CLASSES, MAXHOP,  # noqa: F401
                                       Topology, clos, route, single_switch)
from repro_torch.core.workload import (DLRMCommSpec,  # noqa: F401
                                       DLRMComputeProfile,
                                       DLRMIterationSpec, IterationReport,
                                       build_dlrm_iteration,
                                       simulate_dlrm_iteration,
                                       simulate_dlrm_policies)
