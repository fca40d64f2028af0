from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    PORTED_ARCHS,
    SHAPES,
    ModelConfig,
    RunConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    get_config,
    reduced_config,
    register,
)
