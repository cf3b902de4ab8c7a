"""`repro_torch.fleet` — SLO-aware serving across many slices of one machine
(port of ``repro.fleet``).

    from repro_torch.fleet import (AutoscalerConfig, FleetService,
                                   RouterConfig, TrafficSpec, generate)

    sc = Supercomputer()                 # slices compute on the card
    svc = FleetService(sc, cfg, params, SliceSpec(slots=4),
                       autoscale=AutoscalerConfig(max_replicas=3))
    report = svc.run(generate(TrafficSpec(pattern="bursty")))
    print(report.aggregate_tokens_per_s, report.slo_attainment)

Traffic is open-loop (`traffic`), routing is SLO-aware (`router`), capacity
is elastic (`autoscaler` drives `Supercomputer.allocate`/`Slice.free`), and
a `fail_block` on a serving slice re-routes its in-flight requests to the
surviving replicas instead of erroring the service (`service`).

Every replica serves through the port's `ServeEngine` on the machine's
device; the control logic (routing, autoscaling, failures, virtual time)
is the reference's, so with a fixed ``timing=`` a trace gives the
reference's `FleetReport` exactly.
"""
from repro_torch.fleet.autoscaler import (Autoscaler, AutoscalerConfig,
                                          ForecastConfig, RateForecaster)
from repro_torch.fleet.replica import ReplicaError, ServeReplica
from repro_torch.fleet.router import Router, RouterConfig
from repro_torch.fleet.service import FleetReport, FleetService
from repro_torch.fleet.traffic import (FleetRequest, FleetTrace, SLOTier,
                                       TrafficSpec, generate, generate_legacy,
                                       generate_trace, uniform_burst)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "FleetReport", "FleetRequest",
    "FleetService", "FleetTrace", "ForecastConfig", "RateForecaster",
    "ReplicaError", "Router", "RouterConfig", "SLOTier", "ServeReplica",
    "TrafficSpec", "generate", "generate_legacy", "generate_trace",
    "uniform_burst",
]
