from ssi_jax.models.configs import (  # noqa: F401
    ConfigLlama3_2,
    ModelCheckpointExpectations,
    configllama3_2_1b,
    configllama3_2_3b,
)
