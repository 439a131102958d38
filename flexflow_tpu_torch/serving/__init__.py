"""Inference serving: the session that every serving front end wraps."""
from .session import InferenceSession  # noqa: F401
