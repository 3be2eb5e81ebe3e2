"""Host helpers of the port: the training loop's step timer."""

from speechsplit_tpu_torch.utils.profiling import StepTimer

__all__ = ["StepTimer"]
