from ssi_jax.ops.attention import attention, xla_attention  # noqa: F401
from ssi_jax.ops.cross_entropy import cross_entropy_sum_and_count, fused_cross_entropy  # noqa: F401
