from .machine import DeviceMesh, MachineSpec  # noqa: F401
from .ptensor import ParallelDim, ParallelTensorShape  # noqa: F401
from .strategy import OpSharding, ShardingStrategy  # noqa: F401
