from .mesh import (DeviceSlot, Mesh, device_pool, elastic_pool, make_mesh,
                   make_pipeline_mesh, probe_device, serving_capacity,
                   serving_devices, shard_batch)
from .accumulator import (AdaptiveThresholdAlgorithm,
                          DenseAllReduceAccumulator,
                          EncodedGradientsAccumulator,
                          FixedThresholdAlgorithm, GradientsAccumulator,
                          ReduceScatterAccumulator,
                          TargetSparsityThresholdAlgorithm,
                          ThresholdAlgorithm)
from .wrapper import ParallelWrapper
from .sharding import (Zero1Plan, apply_tp, tp_param_specs, tp_shardings,
                       unflatten_updater_state)
from .inference import ParallelInference
from .serving import (AdmissionController, BrownoutController, BucketLadder,
                      Overloaded, OversizeRequest, PublishHandle,
                      ServingEngine, SLOClass, serving_health)
from .autoscale import Autoscaler, AutoscalePolicy
from .fleet import FleetEarlyStop, FleetStatsSink, FleetTrainer
