"""Host helpers of the port: the profiler's trace and the training
loop's step timer."""

from speechsplit_tpu_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["StepTimer", "profile_trace"]
