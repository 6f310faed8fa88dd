"""Artifact persistence."""

from .checkpoint import ArtifactCache, load_artifact, save_artifact

__all__ = ["ArtifactCache", "load_artifact", "save_artifact"]
