"""The database domain model (port of processing_chain_tpu/config)."""

from .errors import ConfigError
from .domain import (
    Coding,
    Event,
    Hrc,
    PostProcessing,
    Pvs,
    QualityLevel,
    Segment,
    Src,
    YoutubeCoding,
)
from .probe_api import SrcProber, StaticProber
from .test_config import TestConfig

__all__ = [
    "ConfigError",
    "Coding",
    "Event",
    "Hrc",
    "PostProcessing",
    "Pvs",
    "QualityLevel",
    "Segment",
    "Src",
    "YoutubeCoding",
    "SrcProber",
    "StaticProber",
    "TestConfig",
]
