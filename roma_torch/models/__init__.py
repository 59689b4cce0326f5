"""Full RoMa model stack and the matcher API."""

from roma_torch.models.tiny_roma import TinyRoma, TinyRomaMatcher
from roma_torch.models.xfeat import XFeatBackbone

__all__ = ["TinyRoma", "TinyRomaMatcher", "XFeatBackbone"]
