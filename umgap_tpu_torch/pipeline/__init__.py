"""The fused 9-mer analyse pipeline and its streaming runner."""

from .fused import (  # noqa: F401
    PRESETS,
    PipelineConfig,
    make_pipeline,
    pipeline_step,
)
