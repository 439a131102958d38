"""Static analysis: plan verification.

The port of ``flexflow_tpu/analysis``, the serving half of
:mod:`.plan_verifier` so far: :func:`verify_serving_plan` proves a
searched serving plan sound (KV sharding, KV geometry, per-bucket specs)
and within the machine's memory before a device runs it, raising a
typed :class:`PlanVerificationError` with the op attributed. The rest of
the verifier and the lint / concurrency / SPMD engines are ROADMAP queue
1 item 7.
"""
from .plan_verifier import (Finding, PlanReport,  # noqa: F401
                            PlanVerificationError, serving_envelope,
                            verify_serving_plan)
