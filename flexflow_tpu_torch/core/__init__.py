from .tensor import Tensor, WeightSpec  # noqa: F401
from .layer import Layer  # noqa: F401
