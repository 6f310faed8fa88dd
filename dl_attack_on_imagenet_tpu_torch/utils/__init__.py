"""Artifact persistence, metric logging, tracing and step timing."""

from .checkpoint import ArtifactCache, load_artifact, save_artifact
from .metrics_log import MetricLogger
from .profiling import StepTimer, annotate

__all__ = ["ArtifactCache", "MetricLogger", "StepTimer", "annotate",
           "load_artifact", "save_artifact"]
