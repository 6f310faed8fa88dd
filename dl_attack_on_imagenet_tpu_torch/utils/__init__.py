"""Artifact persistence, reference-artifact import, metric logging, tracing,
step timing and seeded generators."""

from .checkpoint import ArtifactCache, load_artifact, save_artifact
from .import_reference import import_adil, import_adilr, import_uap, import_universal
from .metrics_log import MetricLogger
from .profiling import StepTimer, annotate, trace
from .rng import key_seq

__all__ = ["ArtifactCache", "MetricLogger", "StepTimer", "annotate", "import_adil",
           "import_adilr", "import_uap", "import_universal", "key_seq", "load_artifact",
           "save_artifact", "trace"]
