from .mesh import (DeviceSlot, Mesh, axis_slots, device_pool, elastic_pool,
                   make_mesh, make_pipeline_mesh, probe_device,
                   serving_capacity, serving_devices, shard_batch)
from .accumulator import (AdaptiveThresholdAlgorithm,
                          DenseAllReduceAccumulator,
                          EncodedGradientsAccumulator,
                          FixedThresholdAlgorithm, GradientsAccumulator,
                          ReduceScatterAccumulator,
                          TargetSparsityThresholdAlgorithm,
                          ThresholdAlgorithm)
from .wrapper import ParallelWrapper
from .sharding import (NamedSharding, PartitionSpec, ShardedTensor,
                       Zero1Plan, apply_tp, tp_param_specs, tp_shardings,
                       unflatten_updater_state)
from .inference import ParallelInference
from .serving import (AdmissionController, BrownoutController, BucketLadder,
                      Overloaded, OversizeRequest, PublishHandle,
                      ServingEngine, SLOClass, serving_health)
from .autoscale import Autoscaler, AutoscalePolicy
from .fleet import FleetEarlyStop, FleetStatsSink, FleetTrainer
from .ring_attention import ring_attention, ring_self_attention
from .sharded_embeddings import ShardedEmbedding
from .distributed import (AbandonedAttempt, ElasticResizeRequested,
                          HangDetected, Preempted, RestartBudgetExceeded,
                          RestartStorm, SharedTrainingMaster,
                          SupervisedFitResult, TrainingSupervisor,
                          classify_failure, initialize, shutdown,
                          supervise_processes)
from .cluster import (BarrierTimeout, ClusterInitError, ClusterRuntime,
                      GroupCommitError,
                      cpu_multiprocess_collectives_available,
                      merge_rank_blackboxes, read_heartbeats, stale_ranks)
from .pipeline import (HeterogeneousPipeline, PipelineParallel,
                       PipelineTrainer, pipeline_apply, pipeline_from_mln,
                       schedule_meta, stack_stage_params, stage_partition)
