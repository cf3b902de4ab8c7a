"""`repro_torch.cluster` — the port's object model from the OCS fabric to
workloads (port of ``repro.cluster``).

    from repro_torch.cluster import Supercomputer, SliceSpec

    sc = Supercomputer()                 # 64 blocks = 4096 chips, on the card
    sl = sc.allocate((8, 8, 8))          # any 4i x 4j x 4k, from any blocks
    train = sl.train(run_cfg, 30)        # fault-tolerant training session
    serve = sl.serve(run_cfg.model, train.params, SliceSpec(slots=4))
    serve.submit(prompt); serve.run()
    sl.free()

The machine model is the reference's (``repro_torch.core``, copied); the
compute of every slice runs on the machine's device.  The multi-machine
registry and mixed tenancy (``cluster/registry.py``, ``cluster/tenancy.py``)
are not ported: their names raise ``NotImplementedError`` naming ROADMAP.md
queue 1, item 16.
"""
from repro_torch.cluster.slices import (BoundCollectives, ServeSession, Slice,
                                        SliceError, SliceEvent, SliceSession,
                                        TrainSession)
from repro_torch.cluster.straggler import StragglerConfig, StragglerDetector
from repro_torch.cluster.supercomputer import (CapacityError, JobTicket,
                                               Supercomputer)
from repro_torch.serve.engine import SliceSpec


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"repro_torch.cluster.{name} is not ported yet (ROADMAP.md "
            f"queue 1, item 16: cluster/registry.py and cluster/tenancy.py, "
            f"with fleet/)")
    stub.__name__ = stub.__qualname__ = name
    return stub


MachineRegistry = _not_ported("MachineRegistry")
slice_key = _not_ported("slice_key")
ElasticTrainJob = _not_ported("ElasticTrainJob")
MixedTenancyDriver = _not_ported("MixedTenancyDriver")
TenancyReport = _not_ported("TenancyReport")
TrainTenantSpec = _not_ported("TrainTenantSpec")

__all__ = [
    "BoundCollectives", "CapacityError", "ElasticTrainJob", "JobTicket",
    "MachineRegistry", "MixedTenancyDriver", "ServeSession", "Slice",
    "SliceError", "SliceEvent", "SliceSession", "SliceSpec",
    "StragglerConfig", "StragglerDetector", "Supercomputer",
    "TenancyReport", "TrainSession", "TrainTenantSpec", "slice_key",
]
