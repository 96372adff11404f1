"""The port's config dataclasses: a copy of ``dddmr_navigation_tpu/config``
with the same exports (see ``schema.py``)."""
from navbench.reference.config.schema import (
    CuboidConfig,
    TrajectoryGeneratorLimits,
    DDSimpleGeneratorConfig,
    OmniSimpleGeneratorConfig,
    DDRotateInplaceConfig,
    CriticConfig,
    CriticsConfig,
    LocalPlannerConfig,
    PerceptionConfig,
    StaticLayerConfig,
    SpinningLidarConfig,
    GlobalPlannerConfig,
    DWAGlobalPlannerConfig,
    MoveBaseConfig,
    MCLConfig,
    SlamConfig,
    NavigationConfig,
    load_yaml_config,
    load_slam_yaml,
)
