"""Streaming mapping engine: ingest, keyframe store, incremental training."""

from gaussian_lic_tpu_torch.engine.dataset import FrameInput, KeyframeBuffer, TestCamera
from gaussian_lic_tpu_torch.engine.trainer import MappingEngine

__all__ = ["FrameInput", "KeyframeBuffer", "TestCamera", "MappingEngine"]
