from .layers import (Activation, Add, AveragePooling2D,  # noqa: F401
                     BatchNormalization, Concatenate, Conv2D, Dense,
                     Dropout, Embedding, Flatten, Input, LayerNormalization,
                     Maximum, MaxPooling2D, Minimum, MultiHeadAttention,
                     Multiply, Permute, Reshape, Softmax, Subtract)
from .models import Model, Sequential  # noqa: F401
from . import callbacks  # noqa: F401
