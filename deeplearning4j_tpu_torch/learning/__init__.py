from .schedules import (CycleSchedule, ExponentialSchedule, FixedSchedule,
                        InverseSchedule, ISchedule, PolySchedule,
                        SigmoidSchedule, StepSchedule)
from .updaters import (AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, Nadam,
                       Nesterovs, NoOp, RmsProp, Sgd, updater_from_name)
