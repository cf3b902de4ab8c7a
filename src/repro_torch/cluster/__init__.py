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
compute of every slice runs on the machine's device.  `MachineRegistry`
places slices over several machines, of one or several generations
(``cluster/registry.py``); `ElasticTrainJob` and `MixedTenancyDriver` run
training as a preemptible, shrinkable tenant beside a serving fleet
(``cluster/tenancy.py``, with ``repro_torch.fleet``).
"""
from repro_torch.cluster.registry import MachineRegistry, slice_key
from repro_torch.cluster.slices import (BoundCollectives, ServeSession, Slice,
                                        SliceError, SliceEvent, SliceSession,
                                        TrainSession)
from repro_torch.cluster.straggler import StragglerConfig, StragglerDetector
from repro_torch.cluster.supercomputer import (CapacityError, JobTicket,
                                               Supercomputer)
from repro_torch.cluster.tenancy import (ElasticTrainJob, MixedTenancyDriver,
                                         TenancyReport, TrainTenantSpec)
from repro_torch.serve.engine import SliceSpec

__all__ = [
    "BoundCollectives", "CapacityError", "ElasticTrainJob", "JobTicket",
    "MachineRegistry", "MixedTenancyDriver", "ServeSession", "Slice",
    "SliceError", "SliceEvent", "SliceSession", "SliceSpec",
    "StragglerConfig", "StragglerDetector", "Supercomputer",
    "TenancyReport", "TrainSession", "TrainTenantSpec", "slice_key",
]
